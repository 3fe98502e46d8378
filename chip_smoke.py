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
held as lazy array chunks, plain and fused, then a journaled server's
kill -9 and restore at the same size, then `hq server start` itself: the
server in a child process, 1,024 workers (16 of them real port workers)
and a client over TCP, then one real port worker with the machine's CPUs
and the card (`--resource gpus`), then the north star through the port's
own command line (`python -m hyperqueue_tpu_torch` for the server, a real
worker and every client step, beside 1,023 simulated workers), then the
allocation service, then the port's deterministic simulator (the whole
server on a virtual clock, with kill -9 and restore, 15,000 tasks on
1,000 simulated workers), then two federation shards and a standby, and
prints timings. Every process of the port here must run the native codec
(`transport/codec.BACKEND`).

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
     of the workers finish), then 12 pipelined ticks in the server's order
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
     builds it: 8 synchronous and 6 pipelined ticks, every solve's counts
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
     3 under torch.profiler (the device's idle share), then 4 pipelined
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
     policy, 6 ticks on GreedyCutScanModel(backend="device") with prefill;
     the checks of phase 13 (Core.sanity_check aside), K1g held against
     its plain version, every gang all-or-nothing on idle members of one
     group, no excluded (class, group) pair in the solve's placements, and
     one job paused before tick 4 (its chunks held, a queue-paused entry
     with the held count on the paused tick, none of its tasks placed)
     and resumed before tick 5 (everything held back in the queues);
 15. the journal path: a journaled server (server/bootstrap.Server, the
     default scheduler: SolverWatchdog(GreedyCutScanModel()), K1 on the
     card; journal_plane="thread", reattach_timeout=30) on a virtual clock
     that moves only between ticks (TickClock). Its 1,024 workers register
     (worker-connected journaled), the north star arrives as 200 array
     submits through `_client_submit` (one per request class, priority and
     run of up to 16,384 ids, as contiguous id ranges: lazy chunks), then
     4 ticks through ReactorHarness with the server's EventBridge as the
     EventSink and without prefill, one compact_journal (snapshot + GC;
     the journal copied just before it), 3 more ticks, and a kill -9 (the
     JAX simulator's: listeners cleared, journal.kill(), the plane
     dropped). Server B restores from the snapshot plus the tail, server C
     by full replay of the pre-compaction copy plus every later record;
     both boot with one uid. It fails unless B restored from the snapshot
     and C by replay, their fingerprints (tests/test_snapshot.py
     `_fingerprint`) and ledger captures are equal, B materialized exactly
     the ids the journal touched (the rest in chunks), and B's fence
     floor is its generation base. Half of A's workers come back and
     reattach their running tasks (every claim must hold), the other half
     register anew and their tasks' holds expire (requeued, fenced); B then
     runs 2 ticks, which fail on a dispatch of a task A finished or of a
     (task, instance) pair A dispatched, and on Core.sanity_check. Every
     solve of A and B is held against the plain version; each tick logs
     its journal records and bytes, the codec's cost on them (each record
     decoded and encoded again, which must give its payload back), and the
     commit barrier; then the compaction's phases, both restores, the
     journal plane's commits (p50, p99), and the path's peak RSS. The
     ticks run without prefill: a snapshot keeps every materialized task
     (a prefilled backlog too) as its own record while a replay keeps the
     untouched ones in chunks (ROADMAP Queue 3);
 16. the server_start path: `hq server start` through its process
     boundary. The port's Server runs in a child process (multiprocessing,
     spawn; Server(server_dir=, journal_path=, metrics_port=0), every other
     keyword at its default, so K1 on the card; start(), then
     run_until_stopped()), its watchdog's primary wrapped in a recorder
     and the reactor's run_tick in check_assignments. 1,024 simulated
     workers in 4 processes connect to the worker port over TCP through
     transport/auth (encrypted; WIRE_BACKEND printed), register with the
     north star's resources, start each compute entry that fits (the rest
     parked, by priority, as the worker runtime parks them), answer
     task_running, then task_finished after a service time drawn from seed
     42, answer retracts and heartbeat. The client submits the north
     star's 200 arrays back to back over the client plane (the ingest
     thread); after a 20 s window from the first submit one worker drops
     its connection, the workers drain (no more starts; the running tasks
     finish), the client reads server_stats, job_list, job_info,
     worker_list and the flight recorder, /metrics and /readyz are
     scraped, and stop_server follows. It fails unless every K1 launch of
     the child equals its plain version (checked here afterwards, on the
     recorded inputs), every tick's placements fit the free resources,
     no (task, instance) pair was dispatched twice, the dropped worker's
     tasks left it and were dispatched again under a new instance,
     job_info's finished count equals what the workers reported,
     Core.sanity_check passes at shutdown, the child exits 0 within 10 s
     of stop_server with every thread the server started stopped and
     hq-current gone, every solve ran on the card (no host or degraded
     tick), /readyz answers with its solver, journal and ingest checks ok
     (a paging SLO alert may make it 503), and restore_from_journal into a
     fresh Server here gives the finished and running counts the server
     closed its journal with. Logs registration (storm, handshake and
     register round trip), submit acks, the ticks (tick 0, the largest,
     steady median and p99, phases), the rates, the worker plane (frames,
     bytes, encode and decode on both sides, fan-out), the loop lag by
     plane from the scrape, stall captures (and the longest of each plane
     with the stacks its profiler sampled), journal commits, K1 launches
     and the server's peak RSS. SERVE_REAL_WORKERS of the 1,024 rows,
     spread over them, are real port workers (REAL_WORKER_LAUNCHER:
     `worker.runtime.run_worker` with the row's configuration and a
     runner pool of SERVE_REAL_RUNNER_POOL, in processes of their own that
     must import neither torch nor numpy) that run their `true` tasks for
     real (the arrays ask for no output files); they freeze with the
     simulated ones (SIGUSR1: nothing more starts) and each reports a
     server_start_real_worker line: tasks run, compute entries and the
     decode a compute entry, and per task, p50 and p99, the time parked
     (frame to start), the runner dispatch (start to spawn), the run
     (spawn to its finish's uplink) and the total; runner restarts must be
     0 and no task may fail. The summary adds the server's encode in us a
     KB and in seconds, and the shutdown's stop frames encoded before the
     connections closed;
 17. the worker_node path: the deployment HyperQueue documents, one worker
     a node. The server child of phase 16 (K1 on the card every tick) and
     one real port worker built as `hq worker start` builds it
     (detect_resources: every CPU here; the card as `gpus`, counted by
     `nvidia-smi -L` where detect_gpus finds none, which the summary
     says), hwmonitor sampling every NODE_OVERVIEW_S, the runner pool at
     its default width. One array of NODE_TASKS `true` tasks at 1 cpu and
     NODE_GPU_TASKS tasks at 1 cpu and gpus=1, each running `nvidia-smi
     --query-gpu=name,power.limit --format=csv,noheader -i
     $HQ_RESOURCE_VALUES_gpus` between two time stamps. It fails unless
     every task finishes within NODE_DRAIN_S (saying how far it got),
     none fails, each GPU task's stdout names the card, no two GPU tasks
     overlap, the worker's overview carries a GPU sample and every K1
     launch equals its plain version. Logs the spawn floor (a posix_spawn
     of `true` alone), tasks a second, the overhead above the floor, the
     runner pool's width and the codec backend.

 18. the cli path: the north star through the port's own command line,
     every step a `python -m hyperqueue_tpu_torch` process. The server is
     `server start --server-dir D --journal D/journal` with every other
     flag at its default (K1 on the card), run through a launcher
     (cli_server_main) that wraps the model the CLI builds in a recorder
     and the reactor's run_tick in check_assignments before it hands the
     argv to the port's __main__; the time until access.json appears and
     until `hq server wait` returns are logged. 1,023 simulated workers
     with the north star's resources in 4 processes (phase 16's
     serve_worker_proc, each task held for 15-30 min, CLI_SERVICE_S) and
     one real `hq worker start` with the machine's CPUs and one resource
     no simulated row has (CLI_PIN), then `hq
     worker wait 1024` (timed). `hq submit --array 1-100000 --cpus 1 --
     true` (CLI_TASKS) streams one array (its time to the
     "submitted" line and its chunks are logged); then small jobs pinned
     to the real worker by CLI_PIN: an --each-line array of 250 lines
     echoing $HQ_ENTRY, a `job submit-file` TOML graph with dependencies
     and one task that fails; `hq job wait` on them and `hq job cat` of
     the --each-line job's stdout, which must hold its 250 lines. In a
     window of 10 s each read command (`job list`, `job info 1`, `task
     list 1`, `worker list` with its 1,024 rows, `server stats`, `top
     --once --output-mode json`, `task explain` on the middle one of job
     1's waiting tasks, found with `hq job task-ids 1 --filter waiting`,
     which must not have finished)
     runs 3 times, in 3 rounds started 10/3 s apart whose commands run at
     once (wall times, p50 and max, logged); `hq server start --shards 2
     --journal J` must refuse the pair of flags (a shard journals in its
     shard dir) and `hq alloc list` answer (no queue;
     the allocation service runs idle). Then `hq job cancel
     1` and `hq server stop`: the server must exit 0 within 10 s with
     hq-current gone. `hq server start` again over the journal (timed
     until its access file appears), `hq job list --all --output-mode
     json` must give each job's counters as the first server closed its
     journal, `hq journal report` runs under its own limit of 120 s, and
     `hq server stop`. It fails unless every K1 launch of both servers
     equals its plain version (checked here afterwards on the recorded
     inputs), every tick's placements fit, every solve ran on the card,
     every command exits 0 (the refusals non-zero, and `hq job wait` on
     the failing job 1, as the CLI answers a job with failures), every
     client and worker process reports at exit that it loaded neither
     torch, numpy, msgpack, jax nor the JAX package (CLI_LAUNCHER), and
     every process of the port runs the native codec. Logs cli_server,
     cli_submit, cli_small_jobs, cli_commands, cli_stop, cli_restore and
     cli_summary lines (the summary with the steady median of the
     reactor's run_tick, the allocation service idle).
 19. the autoalloc path: the port's `hq server start` on its defaults (K1
     on the card, a journal) through a launcher (alloc_server_main) that
     records, as they happen, every tick solve, every demand query
     (compute_new_worker_query: its assembly, its solve_query and its
     answer), the allocation events and the allocation workers'
     registrations into a file a killed server leaves behind; the
     service runs every ALLOC_INTERVAL_S. Phase 18's 1,023 simulated
     workers and one real `hq worker start`, the 1M-task array, then
     `hq alloc add local --backlog 2 --workers-per-alloc 2` (at most 4
     workers, each `--cpus 1`, reconnecting when the server is lost),
     whose LocalHandler starts real `python -m hyperqueue_tpu_torch
     worker start` processes that register with their allocation. Once
     ALLOC_QUERIES queries ran and the 4 local workers registered, `hq
     alloc list/info/events/log` are read; then `hq alloc add slurm
     --backlog 4 --workers-per-alloc 16 --time-limit 1h` over stub
     `sbatch`/`sacct`/`scancel` on PATH (each query then solves the real
     rows and 4 + 64 fake ones), under a fault plan whose
     `autoalloc.submit` rule kills the server at its second Slurm submit
     (the probe of `alloc add` is the first match). `hq server start`
     again over the journal: the 4 local workers must reattach to their
     allocations (the reconcile's seconds are timed from the launch), the
     Slurm allocations must be one per `sbatch` call but the probe (no
     submit repeated or lost across the kill), and the local queue must
     have submitted nothing more. `hq alloc remove` of both queues: the
     local allocations' process groups must be gone within
     ALLOC_EXIT_S (timed), then `hq server stop`. It fails unless every
     tick of both servers and every query solve equals the plain version
     (the ticks on the card, the queries on the CPU), every query's
     single_node_workers_per_query equals a host recount from the plain
     counts, K1's site counts of each server equal its recorded tick and
     query solves, the residency was never invalidated, and every
     command exits 0. Logs alloc_server, alloc_queries, alloc_reads,
     alloc_kill, alloc_restore, alloc_remove and alloc_summary lines.
 20. the sim path: the port's simulator (hyperqueue_tpu_torch/sim/), the
     real Server (memory_transport=True, every plane on one virtual-clock
     loop) with simulated workers and a client over in-memory streams,
     under `--scheduler greedy` (K1 on the card at every tick) and its
     host twin `greedy-numpy`. Two processes spawned with PYTHONHASHSEED
     SIM_HASH_SEED run the soak (uniform, SIM_SOAK_TASKS tasks of 20 s,
     SIM_SOAK_WORKERS workers of 4 CPUs, schedule_min_delay 0.5, a server
     kill at 30 s and six worker kills, seed 1), one under each scheduler,
     and `python -m hyperqueue_tpu_torch.sim` runs once for its JSON line
     (SIM_CLI_ARGS), while this process runs the determinism pair
     (bursty, seed 42, a server kill at 5 s and a worker kill at 11 s:
     twice under greedy, once under greedy-numpy), the sweep (dag, gang
     and tail under generated faults, seed 7, each under both) and
     replay_compare of the sweep's gang journal, greedy-numpy against
     greedy. It fails unless the greedy pair's decision and journal
     digests are equal, every greedy run's journal and audit equal its
     greedy-numpy twin's (the pair's decisions too, but for the fields
     naming the backend, sim/harness.BACKEND_FIELDS), every task
     finishes, the soak boots twice, every greedy solve launched K1 once
     at the tick site and is one recorded decision (both incarnations),
     device memory is back at its level after each simulation, the replay
     gives equal makespans and assignments, and the entry point exits 0
     with every task finished. Then the soak's widest recorded solve is
     held against the plain version and timed (kernel_timing). Logs
     sim_run, sim_determinism, sim_sweep, sim_replay_compare,
     sim_entry_point, sim_soak (wall seconds, virtual tasks a wall second,
     run_tick p50/p95/p99, device memory) and sim_summary lines.
 21. the federation path (federation_path): two shard processes and a
     warm standby (`--standby --no-coordinator`) of the port's CLI over
     one root, `--lease-timeout 2`, each through ALLOC_SERVER_LAUNCHER;
     the north star's 1,024 worker rows split 512/512 over the shards
     (1,023 simulated, shard 1's reattaching to a successor, and one real
     `worker start --shard 0`); an array of FED_TASKS to each shard from
     the root (`HQ_SHARD`), `job list`, `fleet status` and `top --once`
     at the root, `fleet migrate 1 1`, then a SIGKILL of shard 1: the
     standby claims its lease (epoch 2) and restores it, the workers
     reattach, the jobs drain. It fails unless every task finished once
     (job list --all, and the task-finished records of both journals),
     `server info --shard all` shows epochs 1 and 2 and the promotion,
     `server stop` at the root stops both servers (the standby exits on
     SIGINT), every solve of each process ran on the card, K1's launches
     in each process (both shards and the standby's promoted successor)
     equal its solves, all resident, and every solve equals the plain
     version. Logs federation_start, federation_reads,
     federation_failover (the seconds from the kill to the promotion and
     to the successor's first finished task), federation_stop and
     federation_summary (device memory by process) lines; the kernels
     line's K1 entry carries federation_launches_by_process.

The phase_seconds line gives each phase's seconds.

On every path before the reactor paths the queues must be the native
ones, and every mapping of a tick without gang rows must pop its ids
through hq_map_take (counted; the fused path's gang ticks take per cell in
Python, as the JAX package's do); the reactor paths' classes hold lazy
tasks, so their mappings take per cell in Python and materialize each id,
as the JAX package's do. The mapping line sets the paths' mapping medians
side by side.

Every profiled kernel time comes from a window whose every launch is held
against the plain version's outputs, exact; the profiler loses kernel
events as the process ages (its device clock parts from the host's,
PERF.md §7), so a window in which it kept fewer kernel events than were
launched (none or some) is logged (profiler_empty_window, with what it did record) and
profiled again, at most twice; after three such windows the same launches
are timed back to back between CUDA events queued behind a spin, so that
they hold no host time (profiler_events_fallback, the wrapper's device
span; events_check logs it beside the profiler's time at phase 4's
inputs on every run); a tick window that kept fewer kernel events than
the wrappers launched is logged (profiler_partial_window); the
profiler_windows line counts them all and lists each window's process
uptime, kernel, kept and launched events. `python3 chip_smoke.py
--profiler-bisect [DIR]` (profiler_bisect) probes phase 4's window at the start,
in an idle process once a minute, and after phases 16, 17 and 18.

Each server tick prints its backend and backend_reason: "device-cuda" with
"sync-within-budget" (first solve: no measurement yet, the probe's round
trip fits DISPATCH_LATENCY_BUDGET_MS) or "cost-model" (the measured device
time per shape beats the host's, or the host was never measured); a
"host-*" backend fails the run.

Each kernel's registers, spills and shared memory (nvcc -Xptxas -v) are on
a "ptxas" line per source. The main paths (default, fused, server) must run
every cut-scan solve in the resident instantiation.

The third-to-last line is the kernels JSON (K1, K1g, K5, K2; K1's entry
counts the journal, server_start, worker_node and cli paths' launches
too, the autoalloc path's by site, `tick` and `alloc_query`, and the sim
path's, `sim_launches`), the second-to-last the card;
the last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the process's start, for the uptime profiler_probe logs
PROCESS_T0 = time.monotonic()

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
N_SERVER_PIPELINED_TICKS = 12
# the multichip path: the north star over shards of one card (256 workers
# each), 8 synchronous ticks, then pipelined ones
N_SHARDS = 4
N_MULTICHIP_SYNC_TICKS = 5
N_MULTICHIP_PIPELINED_TICKS = 4

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
N_FUSED_TICKS = 3
MAX_FUSED_GANG_ROWS = 16
N_JOBS = 8
N_GROUPS = 8
N_GANG_TASKS = 160
# the reactor paths (phases 13 and 14)
N_REACTOR_TICKS = 5
N_REACTOR_PIPELINED_TICKS = 4
N_REACTOR_FUSED_TICKS = 6
REACTOR_PAUSED_JOB = 2
REACTOR_PAUSE_TICK = 4
REACTOR_RESUME_TICK = 5
# the journal path: server A's ticks before and after its compaction, the
# restored server B's ticks, the id runs of the array submits, and the
# virtual clock's step between ticks
N_JOURNAL_TICKS = 4
N_JOURNAL_TAIL_TICKS = 3
N_JOURNAL_RESUME_TICKS = 2
JOURNAL_CHUNK = 16384
JOURNAL_TICK_SECONDS = 0.05
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
    bench instance and the first K1g case at 64 batches over 16 and 32
    shards (32 is past any cluster: the grid exchange), and the V x R edge
    cases over 4 (the widest V over 2)."""
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
    # the widest meshes at the bench's and the first K1g case's widths
    # with 64 batches, not 256: the plain version loops over steps and
    # shards, and at 256 these four cases took half of the phase's loop
    for n in (16, 32):
        cases[f"bench_1024x8x64x2_D{n}"] = (bench_instance(n_b=64), n)
        cases[f"gang_solver_1024x8x64x2_G8_D{n}"] = (
            solver_gang_case(500, 1024, 8, 64, 2, 8), n)
    # (the widest V over 2 shards: at 4, with R = 64, it alone took a
    # quarter of the phase's plain loop)
    for name in K2_VR_CASES:
        n = 2 if name == "vr_w64_r64_v2048" else 4
        cases[f"{name}_D{n}"] = (k1_edge_case(name), n)
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


# profiled kernel windows in this run, those in which the profiler
# recorded no time for the kernel, those in which it kept fewer kernel
# events than were launched (it loses them as the process ages: it places
# the device's activity on the host's clock through one calibration a
# process, and on the card's machine the two clocks part by about 50 us a
# second, PERF.md §7), and the kernels timed by CUDA events instead
PROFILED = {"windows": 0, "empty": 0, "partial": 0, "events": 0,
            # each window: [process uptime s, kernel, kept, launched]
            "each": []}
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
    (counts, free, nt_free). A window in which the profiler kept fewer kernel
    events than the `reps` launches (none, or some: a partial window would
    read low) is logged with what it did record and profiled again, at
    most twice; after three such windows the launches are timed with CUDA
    events instead (events_device_ms)."""
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
        kept = sum(e.count for e in events)
        PROFILED["each"].append([round(time.monotonic() - PROCESS_T0, 1),
                                 kernel, kept, reps])
        if total_us > 0 and kept >= reps:
            return total_us / 1e3 / reps
        PROFILED["empty" if total_us <= 0 else "partial"] += 1
        timed = sorted(averages, key=lambda e: -e.device_time_total)[:6]
        log("profiler_empty_window", kernel=kernel, attempt=attempt,
            kept=kept, launched=reps,
            kernel_events=[(e.key, e.count) for e in events],
            device_events=[(e.key, e.count, e.device_time_total)
                           for e in timed if e.device_time_total > 0],
            events=len(prof.events()))
        time.sleep(0.1)
    ms, late = events_device_ms(solve, t, args, opt, want, reps, kernel)
    PROFILED["events"] += 1
    log("profiler_events_fallback", kernel=kernel, ms=ms, reps=reps,
        spin_ran_out=late)
    return ms


# cycles of the spin (torch.cuda._sleep) queued before the launches that
# events_device_ms times, about 2.5 ms on an H100: the launches are queued
# behind it, so no host time falls between its events; doubled, at most 4
# times, where the spin ran out before the last launch was queued
EVENT_SPIN_CYCLES = 5_000_000


def events_device_ms(solve, t, args, opt, want, reps, kernel):
    """Mean device ms of `reps` launches by `solve` at these inputs, back
    to back between two CUDA events queued behind a spin, so that no host
    time falls between them (the wrapper's device span: its kernel, the
    gaps between launches, and any other kernel the wrapper queues). Each
    launch must equal the plain version exactly. Returns the ms and
    whether the spin ran out before the end event was queued even at its
    longest (a wrapper that synchronizes, as a gang row's group check
    does), so that the time may hold host time."""
    import torch

    cycles = EVENT_SPIN_CYCLES
    for _double in range(5):
        states = [(t["free"].clone(), t["nt_free"].clone())
                  for _ in range(reps)]
        spun, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        outs = [(solve(f, n, *args[2:], **opt), f, n) for f, n in states]
        end.record()
        late = spun.query()
        end.synchronize()
        if not late:
            break
        cycles *= 2
    for out in outs:
        for name, got, ref in zip(("counts", "free", "nt_free"), out, want):
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"an event-timed {kernel} launch differs from the "
                    f"plain version on {name}")
    return start.elapsed_time(end) / reps, late


# host seconds a padded profiler window sleeps before its first launch and
# after its last synchronize (profiler_probe)
PROBE_PAD_S = 0.5


def profiler_probe(case, device, tag, card, reps=20):
    """Phase 4's profiler window (kernel_device_ms) alone, at `case`, once
    unpadded and once with PROBE_PAD_S of host sleep at each end inside the
    window: logs per window the kernel events the profiler kept, their
    device ms, and the gap from each launch's runtime call to its kernel's
    start by correlation id (the profiler's raw timestamps: host clock
    against the device's, in us). Each launch is held exact. Returns the
    windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan

    want = plain_outputs(case, device)
    t = to_device(case, device)
    args, opt = _args(t)
    windows = []
    for pad_s in (0.0, PROBE_PAD_S):
        states = [(t["free"].clone(), t["nt_free"].clone())
                  for _ in range(reps + 2)]
        for f, n in states[:2]:
            greedy_cut_scan(f, n, *args[2:], **opt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            outs = [(greedy_cut_scan(f, n, *args[2:], **opt), f, n)
                    for f, n in states[2:]]
            torch.cuda.synchronize()
            time.sleep(pad_s)
        for out in outs:
            for name, got, ref in zip(("counts", "free", "nt_free"), out,
                                      want):
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"a probed launch differs from the plain version "
                        f"on {name}")
        kernels = [e for e in prof.key_averages()
                   if "cut_scan_kernel" in e.key]
        launches, starts, ends, sync_end = {}, {}, [], None
        for ev in prof.profiler.kineto_results.events():
            corr = ev.correlation_id()
            if "cut_scan_kernel" in ev.name():
                starts[corr] = ev.start_ns()
                ends.append(ev.start_ns() + ev.duration_ns())
            elif ev.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                               "cuLaunchKernel", "cuLaunchKernelEx"):
                launches[corr] = ev.start_ns()
            elif "Synchronize" in ev.name():
                sync_end = ev.start_ns() + ev.duration_ns()
        gaps = sorted((starts[c] - launches[c]) / 1e3
                      for c in starts if c in launches)
        window = {
            "at": tag, "pad_s": pad_s,
            "uptime_s": round(time.monotonic() - PROCESS_T0, 1),
            "kernel_events": sum(e.count for e in kernels),
            "kernel_ms": sum(e.self_device_time_total for e in kernels)
            / 1e3 / reps,
            "launch_events": len(launches),
            "raw_kernel_events": len(starts),
            # the host's return from the synchronize minus the last
            # kernel's end on the device's clock: never negative when the
            # two clocks agree
            "sync_end_minus_last_kernel_end_us":
                (sync_end - max(ends)) / 1e3 if ends and sync_end else None,
            "launch_to_kernel_us": {
                "min": gaps[0], "median": gaps[len(gaps) // 2],
                "max": gaps[-1]} if gaps else None,
        }
        log("profiler_probe", **window, card=card)
        windows.append(window)
    return windows


def events_check(case, device, profiled_ms, card):
    """K1 at these inputs timed as events_device_ms times it when the
    profiler records nothing, logged beside the profiler's time so that
    the fallback is held to it on every run (events_check)."""
    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan

    kernel_case = {k: v for k, v in case.items() if not k.startswith("_")}
    t = to_device(kernel_case, device)
    args, opt = _args(t)
    ms, late = events_device_ms(greedy_cut_scan, t, args, opt,
                                plain_outputs(kernel_case, device), 20,
                                "cut_scan_kernel")
    log("events_check", kernel="cut_scan_kernel", events_ms=ms,
        profiler_ms=profiled_ms, spin_ran_out=late, card=card)


def time_plain(case, device, reps=3, plain=None) -> float:
    import torch

    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan_reference

    plain = plain or greedy_cut_scan_reference
    args, opt = _args(to_device(case, device))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    plain(*args, **opt)
    end.record()
    end.synchronize()
    # a plain version that takes a second or more is timed by that call
    if start.elapsed_time(end) >= 1e3:
        return start.elapsed_time(end)
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
        # (a resource the tick assigned none of is not judged: a server
        # worker's free may stand below zero there, see server_start_path)
        if (any(a > f for a, f in zip(u, row.free) if a)
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
    window's wall ms and the device's busy ms and the kernel's ms in it.
    A window whose profiler kept fewer kernel events than the wrapper
    counted launches is logged (profiler_partial_window) and counted in
    PROFILED."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.parallel import solve

    counter = solve.sharded_cut_scan if "sharded" in kernel \
        else assign.greedy_cut_scan
    torch.cuda.synchronize()
    launched = counter.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            one_tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = counter.launches - launched
    events = prof.key_averages()
    kept = sum(e.count for e in events if kernel in e.key)
    PROFILED["windows"] += 1
    PROFILED["each"].append([round(time.monotonic() - PROCESS_T0, 1),
                             kernel, kept, launched])
    if kept < launched:
        PROFILED["partial"] += 1
        log("profiler_partial_window", kernel=kernel, kept=kept,
            launched=launched)
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
                 submitted, seed, events=None, comm=None, prefill=True):
        from hyperqueue_tpu_torch.server import reactor

        self.tag, self.core, self.jobs, self.seam = tag, core, jobs, seam
        # every solve on the device given, none on the host
        self.backend = f"device-{device.type}"
        self.checker, self.device, self.card = checker, device, card
        self.submitted = submitted
        self.reactor = reactor
        # a server's own EventBridge and Comm where the path has a Server
        self.comm = ReactorComm() if comm is None else comm
        self.events = JobSink(core, jobs) if events is None else events
        self.prefill = prefill
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
        self.reactor.schedule(core, self.comm, self.events, self.seam,
                              prefill=self.prefill)
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
        t_answer = time.perf_counter()
        self._start_messages(msgs)
        self._start_backlog(self._finish_quarter())
        self.answer_retracts()
        answer_ms = (time.perf_counter() - t_answer) * 1e3
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
            # the workers' answers (starts, finishes, retracts): where the
            # reactor's events reach the EventSink and, on a journaled
            # server, the journal
            answer_ms=answer_ms,
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
                             "gc_ms", "answer_ms")})
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


class TickClock:
    """The journal path's clock (a utils/clock provider): wall and
    monotonic time that move only when `advance` is called, between ticks,
    as the JAX package's simulator moves its clock between events. A live
    server stamps a finished task twice, the jobs layer's finished_at and
    then the journal record's time; under the system clock the two differ
    by microseconds, so a snapshot restore (which keeps the first) and a
    journal replay (which keeps the second) would differ in the last digits
    that the fingerprint compares."""

    def __init__(self):
        self.t = time.time()
        self.m = time.monotonic()

    def time(self):
        return self.t

    def monotonic(self):
        return self.m

    def advance(self, seconds):
        self.t += seconds
        self.m += seconds


def fingerprint(server) -> dict:
    """Canonical restorable-state dump of a server, as the JAX package's
    tests/test_snapshot.py `_fingerprint` takes it. The ONLY tolerated
    difference between a snapshot restore and a full replay is the
    wall-clock `t_ready` a re-queued task picks up at restore time, so it
    is zeroed for tasks that are not held for reattach."""
    from hyperqueue_tpu_torch.server.protocol import rqv_to_wire

    core = server.core
    jobs = {}
    for job_id, job in server.jobs.jobs.items():
        jobs[job_id] = {
            "name": job.name,
            "open": job.is_open,
            "cancel_reason": job.cancel_reason,
            "submitted_at": round(job.submitted_at, 6),
            "counters": dict(job.counters),
            "submits": job.submits,
            "tasks": {
                t.job_task_id: (
                    t.status, t.error, round(t.submitted_at, 6),
                    t.started_at, t.finished_at,
                )
                for t in job.tasks.values()
            },
        }
    tasks = {}
    body_groups: dict[int, list[int]] = {}
    for task_id, task in core.tasks.items():
        held = task_id in server.reattach_pending
        tasks[task_id] = {
            "instance": task.instance_id,
            "crashes": task.crash_counter,
            "state": task.state.value,
            "priority": task.priority,
            "entry": task.entry,
            "body": task.body,
            "deps": tuple(sorted(task.deps)),
            "crash_limit": task.crash_limit,
            "stamps": (task.t_ready, task.t_assigned, task.t_started)
            if held else (0.0, task.t_assigned, task.t_started),
            "rqv": rqv_to_wire(
                core.rq_map.get_variants(task.rq_id), core.resource_map
            ),
            "held": held,
        }
        body_groups.setdefault(id(task.body), []).append(task_id)
    return {
        "jobs": jobs,
        "tasks": tasks,
        "ready": core.queues.total_ready(),
        "fence_floor": core.instance_fence_floor,
        "event_seq": server._event_seq,
        "uids": sorted(server.journal_uids),
        "n_boots": server.n_boots,
        # identity sharing of array bodies must survive the snapshot (the
        # compute-message dedup depends on it)
        "body_sharing": sorted(
            tuple(sorted(g)) for g in body_groups.values()
        ),
    }


def first_difference(a, b, path="") -> str:
    """Where two fingerprints first differ, for the failure message."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=repr):
            if k not in a or k not in b:
                return f"{path}/{k!r}: only in {'B' if k in a else 'C'}"
            if a[k] != b[k]:
                return first_difference(a[k], b[k], f"{path}/{k!r}")
        return path
    return f"{path}: B {a!r} != C {b!r}"[:400]


def journal_state():
    """The reactor path's north star as a server receives it over the
    wire: the plain state, its 1,024 workers (a configuration, free
    amounts and task slots each) and one array submit per (request class,
    user priority, run of up to JOURNAL_CHUNK ids), in the order of
    lazy_core_from_plain's chunks: the same 200 chunks, each id run
    renumbered to a contiguous `id_range` (the ids are labels; which
    class and priority each run holds is unchanged). Returns (resources,
    workers, submits, n_tasks)."""
    from hyperqueue_tpu_torch.convert import core_from_plain
    from hyperqueue_tpu_torch.server.protocol import rqv_to_wire

    resources, classes, tasks, workers = north_star_state()
    ref = core_from_plain(resources, classes, [], workers)
    sizes: dict = {}
    for _task_id, class_index, (user, _sched) in tasks:
        key = (int(class_index), int(user))
        sizes[key] = sizes.get(key, 0) + 1
    submits, lo = [], 0
    for (class_index, user), n in sizes.items():
        wire = rqv_to_wire(ref.rq_map.get_variants(class_index),
                           ref.resource_map)
        for start in range(0, n, JOURNAL_CHUNK):
            hi = lo + min(JOURNAL_CHUNK, n - start)
            # the body `hq submit --array ... -- true` sends: the client
            # always sends one (ROADMAP Queue 3: an empty body loses its
            # identity sharing across a snapshot restore)
            body = {"cmd": ["true"], "env": {}, "cwd": None,
                    "stdout": None, "stderr": None, "submit_dir": "/"}
            submits.append({
                "name": "north-star", "submit_dir": "/", "open": True,
                "array": {"id_range": [lo, hi], "request": wire,
                          "body": body, "priority": user},
            })
            lo = hi
    worker_rows = [(wid, w.configuration, list(w.free), w.nt_free)
                   for wid, w in sorted(ref.workers.items())]
    return resources, worker_rows, submits, len(tasks)


def register_workers(server, resources, worker_rows):
    """Each worker row registers with the server (reactor.on_new_worker,
    which journals worker-connected) under the server's next worker id,
    with all its resources free (a north-star row's free amounts are its
    total) and the row's task slots. Returns {row's worker id: the
    Worker}."""
    from hyperqueue_tpu_torch.server import reactor
    from hyperqueue_tpu_torch.server.worker import Worker

    core = server.core
    for name in resources:
        core.resource_map.get_or_create(name)
    out = {}
    for wid, config, free, nt_free in worker_rows:
        worker = Worker.create(core.worker_id_counter.next(), config,
                               core.resource_map)
        names = core.resource_map.names()
        got = {names[rid]: a for rid, a in enumerate(worker.free) if a}
        want = {resources[rid]: a for rid, a in enumerate(free) if a}
        if got != want:
            raise AssertionError(f"worker row {wid}: free {want} is not "
                                 f"its total {got}")
        worker.nt_free = nt_free
        reactor.on_new_worker(core, server.comm, server.events, worker)
        out[wid] = worker
    return out


def journal_frames(path, offset):
    """The payloads of the frames appended to a journal file since byte
    `offset`: (payloads, framed bytes read)."""
    import struct

    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    payloads, pos = [], 0
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from("<I", data, pos)
        if pos + 8 + length > len(data):
            break
        payloads.append(data[pos + 8:pos + 8 + length])
        pos += 8 + length
    return payloads, pos


def codec_cost(payloads):
    """The codec on one tick's own journal records: decode every payload,
    encode every record again (which must give the payload back, byte for
    byte), each timed whole. Returns the records and the costs."""
    from hyperqueue_tpu_torch.transport import codec

    t0 = time.perf_counter()
    records = [codec.unpackb(p) for p in payloads]
    t1 = time.perf_counter()
    again = [codec.packb(r) for r in records]
    t2 = time.perf_counter()
    if again != payloads:
        raise AssertionError("journal path: the codec does not give a "
                             "record's payload back")
    n = max(len(payloads), 1)
    mb = sum(len(p) for p in payloads) / 1e6
    return records, {
        "encode_us_per_record": (t2 - t1) / n * 1e6,
        "decode_us_per_record": (t1 - t0) / n * 1e6,
        "encode_mb_s": mb / (t2 - t1) if t2 > t1 else None,
        "decode_mb_s": mb / (t1 - t0) if t1 > t0 else None,
    }


class JournalTap:
    """Reads what a journaled server appended after each tick: the
    records, their bytes, the codec's cost on them, and the kinds."""

    def __init__(self, server):
        self.server = server
        self.offset = server.journal_path.stat().st_size
        self.max_depth = 0

    def after_tick(self):
        jplane = self.server.jplane
        self.max_depth = max(self.max_depth, jplane.depth())
        t0 = time.perf_counter()
        jplane.barrier()
        barrier_ms = (time.perf_counter() - t0) * 1e3
        payloads, n_bytes = journal_frames(self.server.journal_path,
                                           self.offset)
        self.offset += n_bytes
        records, cost = codec_cost(payloads)
        kinds: dict = {}
        for r in records:
            kinds[r["event"]] = kinds.get(r["event"], 0) + 1
        return records, dict(records=len(records), bytes=n_bytes,
                             barrier_ms=barrier_ms, kinds=kinds, **cost)

    def reset(self):
        """After a compaction rewrote the file."""
        self.offset = self.server.journal_path.stat().st_size


def check_plane(server, tag, tap):
    """The commit thread did not die, and every enqueue that found the
    pending bound was counted as a stall."""
    from hyperqueue_tpu_torch.server import journal_plane

    jplane = server.jplane
    if jplane._dead or server._stop_event.is_set():
        raise AssertionError(f"{tag}: the journal plane reported a fatal "
                             "error")
    stalls = journal_plane._STALLS_TOTAL.labels().value
    if tap.max_depth >= jplane.max_pending and stalls < 1:
        raise AssertionError(f"{tag}: the pending bound was reached "
                             f"({tap.max_depth}) with no stall counted")
    return dict(jplane.stats(), records=jplane.records,
                commit_ms=jplane.commit_ms(), stalls_total=stalls,
                max_depth_seen=tap.max_depth,
                max_pending=jplane.max_pending)


def journal_path(card, device):
    """Phase 15: the journal. A journaled Server (the port's
    server/bootstrap.py) on the default scheduler, K1 on the card: 1,024
    workers register, the north star arrives as 200 array submits through
    `_client_submit` (lazy chunks), 4 ticks through ReactorHarness with
    the server's EventBridge as the EventSink, one compact_journal
    (snapshot + GC), 3 more ticks, then a kill -9 of the server (the
    JAX simulator's: listeners cleared, journal.kill(), the plane
    dropped). Server B restores from the snapshot plus the journal's tail,
    server C by full replay of the pre-compaction journal plus every later
    record; B and C must hold the same state (the fingerprint) and the
    same usage ledger. Half of A's workers come back and reattach their
    running tasks, the other half register anew and their tasks' holds
    expire (fenced, requeued); B then runs 2 ticks on the card. Returns the
    path's summary."""
    import asyncio
    import resource
    import secrets
    import shutil
    import tempfile
    from pathlib import Path

    from hyperqueue_tpu_torch.events.journal import Journal
    from hyperqueue_tpu_torch.ids import task_id_job, task_id_task
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.parallel import solve
    from hyperqueue_tpu_torch.server import reactor
    from hyperqueue_tpu_torch.server.bootstrap import Server
    from hyperqueue_tpu_torch.server.task import (
        INSTANCE_GENERATION_STRIDE,
        TaskState,
    )
    from hyperqueue_tpu_torch.utils import clock

    t_path = time.perf_counter()
    resources, worker_rows, submits, n_tasks = journal_state()
    log("journal_state", workers=len(worker_rows), submits=len(submits),
        tasks=n_tasks, seconds=round(time.perf_counter() - t_path, 3),
        card=card)
    submitted = {1: n_tasks}
    checker = GreedyCutScanModel(device="cuda", backend="device")
    tick_clock = TickClock()
    previous_clock = clock.install(tick_clock)
    tmp = Path(tempfile.mkdtemp(prefix="hq-journal-"))
    journal = tmp / "journal.bin"
    full = tmp / "full.bin"
    uid_a, uid_b = secrets.token_hex(8), secrets.token_hex(8)
    server_kwargs = dict(journal_plane="thread", reattach_timeout=30.0,
                         # every array submit is a lazy chunk, as
                         # lazy_core_from_plain holds them
                         lazy_array_threshold=1)
    out: dict = {}
    try:
        # counts to 0 just before the path
        assign.reset_launch_counts()
        solve.reset_launch_counts()

        # --- server A's whole life on one event loop -------------------
        async def life_a():
            a = Server(server_dir=tmp / "a", journal_path=journal,
                       **server_kwargs)
            await a._open_journal(uid_a)
            a.comm = ReactorComm()
            t0 = time.perf_counter()
            by_row = register_workers(a, resources, worker_rows)
            for i, desc in enumerate(submits):
                if i:
                    desc = dict(desc, job_id=1)
                reply = await a._client_submit({"job": desc})
                if reply.get("op") != "submit_response":
                    raise AssertionError(f"journal path: submit {i}: "
                                         f"{reply}")
            job = a.jobs.jobs[1]
            if job.n_lazy != n_tasks or job.tasks \
                    or len(a.core.lazy.segments_of(1)) != len(submits):
                raise AssertionError(
                    f"journal path: {job.n_lazy} lazy, {len(job.tasks)} "
                    f"materialized, {len(a.core.lazy.segments_of(1))} "
                    "chunks after the submits")
            tap = JournalTap(a)
            a.jplane.barrier()
            tap.reset()
            log("journal_submitted", chunks=len(submits),
                seconds=round(time.perf_counter() - t0, 3),
                journal_bytes=journal.stat().st_size, card=card)
            seam = RecordingSeam(a.model)
            h = ReactorHarness("journal", a.core, a.jobs, seam, checker,
                               device, card, submitted, SEED + 9,
                               events=a.events, comm=a.comm, prefill=False)
            dispatched: set = set()
            ticks = []
            try:
                for i in range(N_JOURNAL_TICKS + N_JOURNAL_TAIL_TICKS):
                    if i == N_JOURNAL_TICKS:
                        a.jplane.barrier(sync=True)
                        shutil.copyfile(journal, full)
                        compaction = await a.compact_journal(
                            reason="chip-smoke")
                        tap.reset()
                        log("journal_compaction", **compaction,
                            full_copy_bytes=full.stat().st_size,
                            card=card)
                        out["compaction"] = compaction
                    tick_clock.advance(JOURNAL_TICK_SECONDS)
                    summary = h.tick()
                    for _wid, batch in h.comm.compute:
                        for m in batch:
                            dispatched.add((m["id"], m["instance"]))
                    _records, jstats = tap.after_tick()
                    ticks.append(dict(summary, journal=jstats))
                    log("journal_tick", server="A", tick=summary["tick"],
                        wall_ms=summary["wall_ms"],
                        phases=summary["phases"],
                        answer_ms=summary["answer_ms"],
                        messages=summary["messages"],
                        materialized=summary["materialized"],
                        gc_ms=summary["gc_ms"], **jstats, card=card)
                out["plane_a"] = check_plane(a, "server A", tap)
                # kill -9, as the JAX simulator does it; the barrier first
                # (so the journal holds every event of the 7 ticks), then
                # the plane's thread, which holds nothing, is joined
                a.jplane.barrier()
                a._event_listeners.clear()
                a._subscribers.clear()
                a.journal.kill()
                a.journal = None
                a.jplane.stop()
                a.jplane = None
            finally:
                h.close()
            # what the workers held at the crash: their running tasks,
            # by worker (the reattach claims)
            claims = {
                wid: [(tid, a.core.tasks[tid].instance_id,
                       a.core.tasks[tid].assigned_variant)
                      for tid in tids]
                for wid, tids in h.running.items() if tids
            }
            row_of = {w.worker_id: row for row, w in by_row.items()}
            return dict(ticks=ticks, dispatched=dispatched, claims=claims,
                        row_of=row_of, solves=len(seam.calls),
                        seq=a._event_seq)

        t0 = time.perf_counter()
        life = asyncio.run(life_a())
        a_seconds = time.perf_counter() - t0
        launches_a = assign.greedy_cut_scan.launches
        resident_a = assign.greedy_cut_scan.resident_launches
        gc.collect()

        # C's journal: the pre-compaction copy plus every record of A's
        # journal past the copy's last seq
        full_records = list(Journal.read_all(full))
        last_seq = full_records[-1]["seq"]
        a_records = list(Journal.read_all(journal))
        tail = [r for r in a_records if r.get("seq", -1) > last_seq]
        c_journal = tmp / "c.bin"
        shutil.copyfile(full, c_journal)
        jw = Journal(c_journal)
        jw.open_for_append()
        for r in tail:
            jw.write(r)
        jw.close()
        touched, finished = set(), set()
        for r in full_records + tail:
            if r.get("job") == 1 and r["event"] in (
                    "task-started", "task-finished", "task-restarted",
                    "task-failed", "task-canceled"):
                touched.add(r["task"])
                if r["event"] == "task-finished":
                    finished.add(r["task"])
        del full_records, a_records, tail

        # --- server B: restore, resume on the card ---------------------
        async def life_b():
            b = Server(server_dir=tmp / "b", journal_path=journal,
                       **server_kwargs)
            await b._open_journal(uid_b)
            # the comparator: a full replay of C's journal, booted with
            # the same uid so both servers stand at the same boot
            c = Server(server_dir=tmp / "c", journal_path=c_journal,
                       **server_kwargs)
            await c._open_journal(uid_b)
            restore = {"B": dict(b.last_restore,
                                 materialized=len(b.core.tasks),
                                 job_tasks=len(b.jobs.jobs[1].tasks),
                                 n_lazy=b.jobs.jobs[1].n_lazy),
                       "C": dict(c.last_restore,
                                 materialized=len(c.core.tasks),
                                 job_tasks=len(c.jobs.jobs[1].tasks),
                                 n_lazy=c.jobs.jobs[1].n_lazy)}
            log("journal_restore", **restore, touched_ids=len(touched),
                card=card)
            if restore["B"]["snapshot"] is None \
                    or restore["C"]["snapshot"] is not None:
                raise AssertionError(f"journal path: restore sources "
                                     f"{restore}")
            fb, fc = fingerprint(b), fingerprint(c)
            if fb != fc:
                raise AssertionError("journal path: B's fingerprint differs "
                                     f"from C's at {first_difference(fb, fc)}")
            ledger_b, ledger_c = b.accounting.capture(), \
                c.accounting.capture()
            if ledger_b != ledger_c:
                raise AssertionError("journal path: B's ledger differs from "
                                     "C's")
            c._close_journal()
            del c, fb, fc
            job = b.jobs.jobs[1]
            if len(job.tasks) != len(touched) \
                    or job.n_lazy + len(job.tasks) != n_tasks:
                raise AssertionError(
                    f"journal path: B materialized {len(job.tasks)} tasks "
                    f"for {len(touched)} touched ids ({job.n_lazy} lazy of "
                    f"{n_tasks})")
            fence = max(b.n_boots - 1, 1) * INSTANCE_GENERATION_STRIDE
            if b.core.instance_fence_floor != fence:
                raise AssertionError(f"journal path: fence floor "
                                     f"{b.core.instance_fence_floor}, "
                                     f"expected {fence}")
            held_at_restore = len(b.reattach_pending)
            # the workers come back: the odd rows reattach their running
            # tasks (the handler Server._process_reattach calls), the even
            # rows register anew, their tasks' holds expire
            b.comm = ReactorComm()
            back = {}
            for row in worker_rows:
                back.update(register_workers(b, resources, [row]))
            running: dict = {}
            reattached = discarded = 0
            uid_ok = uid_a in b.journal_uids
            for old_wid, claims in life["claims"].items():
                row = life["row_of"][old_wid]
                if row % 2 == 0:
                    continue
                worker = back[row]
                for tid, instance, _variant in claims:
                    task = b.core.tasks.get(tid)
                    claimable = (uid_ok and task is not None
                                 and not task.is_done
                                 and task.instance_id == instance)
                    if claimable and b.reattach_pending.pop(tid, None) \
                            is not None:
                        reactor.on_task_reattached(b.core, b.events, task,
                                                   worker)
                        running.setdefault(worker.worker_id,
                                           []).append(tid)
                        reattached += 1
                    else:
                        discarded += 1
            if discarded:
                raise AssertionError(f"journal path: {discarded} reattach "
                                     "claims discarded")
            # the reattach window closes: Server._reattach_reaper's pass
            tick_clock.advance(b.reattach_timeout + 1.0)
            now = clock.monotonic()
            expired = [tid for tid, deadline in b.reattach_pending.items()
                       if deadline <= now]
            requeued = 0
            for task_id in expired:
                del b.reattach_pending[task_id]
                task = b.core.tasks.get(task_id)
                if (task is None or task.is_done
                        or task.state is not TaskState.WAITING):
                    continue
                reactor.requeue_reattach_expired(b.core, b.comm, task)
                requeued += 1
            if b.reattach_pending:
                raise AssertionError(f"journal path: {len(b.reattach_pending)}"
                                     " holds outlived the window")
            b.core.sanity_check()
            log("journal_reattach", held=held_at_restore,
                reattached=reattached, requeued=requeued,
                workers=len(b.core.workers), card=card)
            tap = JournalTap(b)
            b.jplane.barrier()
            tap.reset()
            seam = RecordingSeam(b.model)
            h = ReactorHarness("journal_b", b.core, b.jobs, seam, checker,
                               device, card, submitted, SEED + 10,
                               events=b.events, comm=b.comm, prefill=False)
            h.running = running
            ticks = []
            try:
                for _ in range(N_JOURNAL_RESUME_TICKS):
                    tick_clock.advance(JOURNAL_TICK_SECONDS)
                    summary = h.tick()
                    for _wid, batch in h.comm.compute:
                        for m in batch:
                            if task_id_job(m["id"]) == 1 and \
                                    task_id_task(m["id"]) in finished:
                                raise AssertionError(
                                    f"journal path: B dispatched task "
                                    f"{m['id']}, which A finished")
                            if (m["id"], m["instance"]) in \
                                    life["dispatched"]:
                                raise AssertionError(
                                    f"journal path: B dispatched {m['id']} "
                                    f"at instance {m['instance']}, as A did")
                    b.core.sanity_check()
                    _records, jstats = tap.after_tick()
                    ticks.append(dict(summary, journal=jstats))
                    log("journal_tick", server="B", tick=summary["tick"],
                        wall_ms=summary["wall_ms"],
                        phases=summary["phases"],
                        answer_ms=summary["answer_ms"],
                        messages=summary["messages"],
                        materialized=summary["materialized"],
                        gc_ms=summary["gc_ms"], **jstats, card=card)
                plane_b = check_plane(b, "server B", tap)
                b._close_journal()
            finally:
                h.close()
            return dict(restore=restore, ticks=ticks, plane=plane_b,
                        reattached=reattached, requeued=requeued,
                        held=held_at_restore, solves=len(seam.calls))

        t0 = time.perf_counter()
        life_b_out = asyncio.run(life_b())
        b_seconds = time.perf_counter() - t0
    finally:
        clock.install(previous_clock)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"cut_scan": assign.greedy_cut_scan.launches,
                "cut_scan_resident": assign.greedy_cut_scan.resident_launches,
                "cut_scan_gang": assign.greedy_cut_scan.gang_launches,
                "sharded_scan": solve.sharded_cut_scan.launches}
    n_solves = life["solves"] + life_b_out["solves"]
    if (launches["cut_scan"] != n_solves or launches["cut_scan_gang"]
            or launches["cut_scan_resident"] != n_solves
            or launches["sharded_scan"] or launches_a != life["solves"]
            or resident_a != launches_a or not life_b_out["solves"]):
        raise AssertionError(f"journal path launches {launches} for "
                             f"{life['solves']} + {life_b_out['solves']} "
                             "solves")

    def medians(ticks):
        steady = ticks[1:]
        return {k: float(np.median([t[k] for t in steady]))
                for k in ("wall_ms", "answer_ms", "messages")} | {
            f"journal_{k}": float(np.median([t["journal"][k]
                                             for t in steady]))
            for k in ("records", "bytes", "barrier_ms",
                      "encode_us_per_record", "decode_us_per_record",
                      "encode_mb_s", "decode_mb_s")}

    summary = dict(
        ticks_a=len(life["ticks"]), ticks_b=len(life_b_out["ticks"]),
        a_first_tick_ms=life["ticks"][0]["wall_ms"],
        a_medians=medians(life["ticks"]),
        b_first_tick_ms=life_b_out["ticks"][0]["wall_ms"],
        b_steady_tick_ms=life_b_out["ticks"][-1]["wall_ms"],
        launches=launches, launches_a=launches_a,
        launches_b=launches["cut_scan"] - launches_a,
        solves=n_solves, plane_a=out["plane_a"], plane_b=life_b_out["plane"],
        compaction_phases_ms=out["compaction"]["phases_ms"],
        restore=life_b_out["restore"], held=life_b_out["held"],
        reattached=life_b_out["reattached"],
        requeued=life_b_out["requeued"], touched_ids=len(touched),
        finished_in_a=len(finished),
        a_seconds=a_seconds, b_and_c_seconds=b_seconds,
        seconds=time.perf_counter() - t_path,
        peak_rss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)
    log("journal_summary", **summary, card=card)
    return summary


# -- phase 16: `hq server start` over TCP --------------------------------------
# the window the workers run tasks for, from the first array's ack
SERVE_WINDOW_S = 20.0
# processes the 1,024 simulated workers are spread over (decode and seal of
# the compute frames is CPU work under one GIL each)
SERVE_WORKER_PROCS = 4
# a task's service time on a simulated worker, uniform in this range (s)
SERVE_SERVICE_S = (1.0, 6.0)
# a simulated worker batches its uplink messages for this long, as the
# worker runtime does (`uplink_flush_secs`)
SERVE_FLUSH_S = 0.005
# 1,024 worker connections plus the server's own files and sockets
SERVE_MIN_NOFILE = 4096
# handshakes a worker process keeps in flight at once: the server listens
# with asyncio's default backlog of 100, which 1,024 workers connecting in
# the same instant overflow (the kernel then resets connections); a fleet
# started by a batch system does not arrive in one instant either
SERVE_CONNECT_CONCURRENCY = 16
SERVE_CONNECT_ATTEMPTS = 3
# the child server must be gone this long after `stop_server`
SERVE_EXIT_S = 10.0


# real port workers beside the simulated ones: rows of the north star that
# run `run_worker` in processes of their own, each with a runner pool
SERVE_REAL_WORKERS = 16
SERVE_REAL_RUNNER_POOL = 1
# phase 17: one worker node, the machine's CPUs and its GPUs
# (50,000 at first, then 10,000, which drained for 25-45 s; cut to keep
# the whole run well inside its time limit)
NODE_TASKS = 2_000
NODE_GPU_TASKS = 8
NODE_DRAIN_S = 180.0
NODE_OVERVIEW_S = 1.0

# A port worker process: `run_worker` with the WorkerConfiguration the
# parent wrote (phase 16: a north-star row's), or one built as `hq worker
# start` builds it (phase 17: detect_resources, the `gpus` item counted by
# `nvidia-smi -L` where detection finds none, then descriptor.validate()).
# The launcher (not the worker's modules) measures: the codec's decode of
# each frame that carries compute entries, and per task the frame's
# receipt, the task's start (its allocation), its runner dispatch and the
# send of its finish, and the frames it sends and the messages in them.
# SIGUSR1 freezes the worker (nothing more starts; the
# allocator refuses, as a full worker's does) and, once its running tasks
# finished and their uplinks were sent, writes `<result>.frozen`. After
# registration it writes `<result>.registered`; when the worker stops it
# writes `<result>` (JSON). Imports only the port's worker and its
# dependencies: it fails if torch, numpy, msgpack, jax or the JAX package
# were loaded.
REAL_WORKER_LAUNCHER = r"""
import asyncio, json, os, signal, subprocess, sys, time
from pathlib import Path

mode, config_path, server_dir, result = sys.argv[1:5]
from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptor
from hyperqueue_tpu_torch.server.worker import WorkerConfiguration
from hyperqueue_tpu_torch.transport import auth, codec
from hyperqueue_tpu_torch.utils import serverdir
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.worker import allocator, runtime
from hyperqueue_tpu_torch.worker.hwdetect import detect_gpus, detect_resources
from hyperqueue_tpu_torch.worker.parser import parse_resource_definition

out = {"codec": codec.BACKEND, "mode": mode, "compute_frames": 0,
       "entries": 0, "decode_s": 0.0, "finished": 0, "failed": 0,
       "uplink_frames": 0, "uplink_msgs": 0, "stop_read": False,
       "dispatched": []}
if mode == "row":
    with open(config_path) as f:
        config = WorkerConfiguration.from_wire(json.load(f))
else:
    descriptor = detect_resources()
    out["detected_gpus"] = detect_gpus() is not None
    if not out["detected_gpus"]:
        listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                text=True, timeout=60).stdout
        n = sum(1 for line in listed.splitlines()
                if line.startswith("GPU "))
        items = {item.name: item for item in descriptor.items}
        items["gpus"] = parse_resource_definition(
            "gpus=[" + ",".join(str(i) for i in range(n)) + "]")
        descriptor = ResourceDescriptor(items=tuple(items.values()))
    descriptor.validate()
    config = WorkerConfiguration(
        descriptor=descriptor, hostname=os.uname().nodename,
        overview_interval_secs=float(mode.split(":")[1]))
out["resources"] = {item.name: item.total_amount()
                    for item in config.descriptor.items}
stamps = {}
last_frame = [0.0]
frozen = [False]
holder = {}

unpack = auth.unpack_payload


def timed_unpack(data):
    t0 = time.perf_counter()
    msg = unpack(data)
    t1 = time.perf_counter()
    subs = msg["msgs"] if msg.get("op") == "batch" else (msg,)
    n = sum(len(m["tasks"]) for m in subs if m.get("op") == "compute")
    if n:
        out["compute_frames"] += 1
        out["entries"] += n
        out["decode_s"] += t1 - t0
    last_frame[0] = t1
    return msg


auth.unpack_payload = timed_unpack
handle = runtime.WorkerRuntime._handle_server_message


async def timed_handle(self, msg):
    op = msg.get("op")
    if op == "compute":
        for e in msg["tasks"]:
            key = (e["id"], e.get("instance", 0))
            stamps[key] = [last_frame[0], None, None, None]
            out["dispatched"].append(key)
    elif op == "stop":
        out["stop_read"] = True
    return await handle(self, msg)


runtime.WorkerRuntime._handle_server_message = timed_handle
start_with = runtime.WorkerRuntime._start_with_allocation


def timed_start(self, task_msg, allocation):
    s = stamps.get((task_msg["id"], task_msg.get("instance", 0)))
    if s is not None:
        s[1] = time.perf_counter()
    return start_with(self, task_msg, allocation)


runtime.WorkerRuntime._start_with_allocation = timed_start
launch = runtime.WorkerRuntime._launch


async def timed_launch(self, task_msg, *args, **kwargs):
    launched = await launch(self, task_msg, *args, **kwargs)
    s = stamps.get((task_msg["id"], task_msg.get("instance", 0)))
    if s is not None:
        s[2] = time.perf_counter()
    return launched


runtime.WorkerRuntime._launch = timed_launch
send = auth.Connection.send


async def timed_send(self, obj):
    await send(self, obj)
    t = time.perf_counter()
    subs = obj["msgs"] if obj.get("op") == "batch" else (obj,)
    out["uplink_frames"] += 1
    out["uplink_msgs"] += len(subs)
    for m in subs:
        op = m.get("op")
        if op == "task_finished":
            out["finished"] += 1
            s = stamps.get((m["id"], m.get("instance", 0)))
            if s is not None:
                s[3] = t
        elif op == "task_failed":
            out["failed"] += 1
            out.setdefault("errors", []).append(str(m.get("error"))[:200])


auth.Connection.send = timed_send
try_allocate = allocator.ResourceAllocator.try_allocate


def frozen_try_allocate(self, entries):
    return None if frozen[0] else try_allocate(self, entries)


allocator.ResourceAllocator.try_allocate = frozen_try_allocate


async def freeze():
    frozen[0] = True
    rt = holder["runtime"]
    deadline = time.monotonic() + 60.0
    quiet = 0
    while quiet < 3 and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
        busy = rt.running or rt._sendq.qsize()
        quiet = 0 if busy else quiet + 1
    Path(result + ".frozen").write_text(json.dumps({
        "finished": out["finished"], "running": len(rt.running),
        "parked": rt._n_blocked}))


connect = runtime.WorkerRuntime._initial_connect


async def registered_connect(self):
    await connect(self)
    holder["runtime"] = self
    asyncio.get_running_loop().add_signal_handler(
        signal.SIGUSR1, lambda: asyncio.ensure_future(freeze()))
    Path(result + ".registered").write_text(str(self.worker_id))


runtime.WorkerRuntime._initial_connect = registered_connect
access = serverdir.load_access(Path(server_dir))
t_run = time.perf_counter()
try:
    asyncio.run(runtime.run_worker(
        access.host_for_workers(), access.worker_port,
        access.worker_key_bytes(), config, server_dir=Path(server_dir)))
except Exception as e:
    out["error"] = repr(e)
rt = holder.get("runtime")
spans = [s for s in stamps.values() if s[3] is not None]
out.update(
    seconds=time.perf_counter() - t_run,
    worker_id=rt.worker_id if rt else None,
    runner_pool=rt.runner_pool.size if rt and rt.runner_pool else 0,
    runner_restarts=REGISTRY.get(
        "hq_worker_runner_restarts_total").labels().value,
    runner_crash_fails=REGISTRY.get(
        "hq_worker_runner_crash_failed_tasks_total").labels().value,
    # ms: frame -> start (parked until resources free up), start ->
    # runner dispatch, dispatch -> finish sent (the run and its exit),
    # frame -> finish sent
    parked_ms=[(s[1] - s[0]) * 1e3 for s in spans if s[1] is not None],
    dispatch_ms=[(s[2] - s[1]) * 1e3 for s in spans
                 if s[1] is not None and s[2] is not None],
    run_ms=[(s[3] - s[2]) * 1e3 for s in spans if s[2] is not None],
    total_ms=[(s[3] - s[0]) * 1e3 for s in spans],
    foreign=sorted(m for m in sys.modules if m.split(".")[0] in (
        "torch", "numpy", "msgpack", "jax", "hyperqueue_tpu")))
Path(result).write_text(json.dumps(out))
"""


def start_real_worker(mode, config, server_dir, result):
    """A port worker in a process of its own (REAL_WORKER_LAUNCHER):
    `mode` "row" runs `config` (a WorkerConfiguration's wire form),
    "node:<overview s>" detects the machine's resources. Its output goes
    to `<result>.log`."""
    config_path = f"{result}.config"
    with open(config_path, "w") as f:
        json.dump(config or {}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ,
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             "")}
    log_f = open(f"{result}.log", "wb")
    try:
        return subprocess.Popen(
            [sys.executable, "-c", REAL_WORKER_LAUNCHER, mode, config_path,
             str(server_dir), str(result)],
            env=env, cwd=root, stdout=log_f, stderr=subprocess.STDOUT)
    finally:
        log_f.close()


def real_worker_line(res):
    """One real worker's report: tasks run, decode a compute entry, and
    each stage of a task's way through it (ms, p50 and p99)."""
    line = {
        "worker_id": res.get("worker_id"),
        "resources": res.get("resources"),
        "codec": res.get("codec"), "runner_pool": res.get("runner_pool"),
        "runner_restarts": res.get("runner_restarts"),
        "tasks_run": res.get("finished"), "failed": res.get("failed"),
        "compute_entries": res.get("entries"),
        "compute_frames": res.get("compute_frames"),
        "uplink_frames": res.get("uplink_frames"),
        "uplink_msgs": res.get("uplink_msgs"),
        "decode_us_per_entry": res.get("decode_s", 0.0)
        / max(res.get("entries") or 0, 1) * 1e6,
        "stop_read": res.get("stop_read")}
    for key in ("parked_ms", "dispatch_ms", "run_ms", "total_ms"):
        values = res.get(key) or []
        line[key] = {"p50": _pctl(values, 50), "p99": _pctl(values, 99),
                     "n": len(values)}
    return line


def real_worker_faults(res, name):
    """What a real worker's report says went wrong (a list of strings)."""
    fails = []
    if res.get("codec") != "native":
        fails.append(f"{name}: codec backend {res.get('codec')}")
    if res.get("foreign"):
        fails.append(f"{name}: imported {res['foreign'][:5]}")
    if res.get("error"):
        fails.append(f"{name}: {res['error']}")
    if res.get("runner_restarts") or res.get("runner_crash_fails"):
        fails.append(f"{name}: {res.get('runner_restarts')} runner "
                     f"restarts, {res.get('runner_crash_fails')} tasks "
                     "failed by a runner crash")
    if res.get("failed"):
        fails.append(f"{name}: {res['failed']} tasks failed "
                     f"({res.get('errors', [])[:2]})")
    if not res.get("runner_pool"):
        fails.append(f"{name}: no runner pool")
    return fails


def wait_files(paths, what, timeout, procs=()):
    """Waits until every path exists; fails naming `what` when one of
    `procs` exits first or `timeout` passes."""
    deadline = time.monotonic() + timeout
    while True:
        missing = [p for p in paths if not os.path.exists(p)]
        if not missing:
            return
        dead = [p.returncode for p in procs if p.poll() is not None]
        if dead or time.monotonic() > deadline:
            raise AssertionError(f"{what}: {len(missing)} of {len(paths)} "
                                 f"missing after {timeout} s (exited: "
                                 f"{dead})")
        time.sleep(0.05)


def spawn_floor_ms(n=200):
    """A posix_spawn of `true` and its wait, alone: the floor a task's
    run stands on here (ms, p50 and p99)."""
    import shutil

    true = shutil.which("true")
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        pid = os.posix_spawn(true, [true], dict(os.environ))
        os.waitpid(pid, 0)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"p50": _pctl(times, 50), "p99": _pctl(times, 99), "n": n}


def raise_nofile_limit():
    """Soft RLIMIT_NOFILE up to the hard limit, before any process is
    spawned (children inherit it): the server holds one descriptor per
    worker connection and the workers' processes one each too. Fails,
    with both numbers, when the hard limit is under SERVE_MIN_NOFILE."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    target = hard if hard != resource.RLIM_INFINITY else max(soft, 1 << 16)
    if target < SERVE_MIN_NOFILE:
        raise AssertionError(
            f"RLIMIT_NOFILE: hard limit {hard}, soft {soft}; the "
            f"server_start path needs {SERVE_MIN_NOFILE} descriptors")
    if soft != target:
        resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
    return soft, target


def rss_mb():
    """This process's resident set now and its peak since its exec (a
    spawned process's ru_maxrss also counts the parent it was forked
    from), in MB; None where /proc does not say."""
    now = peak = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) / 1024
                elif line.startswith("VmRSS:"):
                    now = int(line.split()[1]) / 1024
    except OSError:
        pass
    if now is None:
        try:
            with open("/proc/self/statm") as f:
                now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") \
                    / 2**20
        except (OSError, ValueError, IndexError):
            pass
    return now, peak


def _timed(fn, acc, lock, key):
    """`fn` timed into acc[key + "_n" / "_s" / "_bytes"] (the server's
    sender threads encode concurrently, hence the lock)."""
    def wrapped(arg):
        t0 = time.perf_counter()
        out = fn(arg)
        dt = time.perf_counter() - t0
        n = len(out) if key == "encode" else len(arg)
        with lock:
            acc[f"{key}_n"] += 1
            acc[f"{key}_s"] += dt
            acc[f"{key}_bytes"] += n
        return out
    return wrapped


def install_tick_check(failures, on_tick=None):
    """Wraps the reactor's run_tick in check_assignments: each tick's
    placements must fit the free resources and task slots it was given.
    A misfit is appended to `failures`. Returns the counts of ticks and
    assigned tasks and each run_tick's wall ms (under "ms"), which the
    wrapper keeps up to date; `on_tick(ms)` is called after each."""
    import types

    from hyperqueue_tpu_torch.server import reactor

    run_tick = reactor.run_tick
    assigned = {"ticks": 0, "tasks": 0, "ms": []}

    def checked_run_tick(*args, **kwargs):
        dense = kwargs.get("dense")
        if dense is not None:
            rows = [types.SimpleNamespace(
                worker_id=wid, free=[int(a) for a in dense.free[i]],
                nt_free=int(dense.nt_free[i]))
                for i, wid in enumerate(dense.worker_ids)]
        else:
            rows = [types.SimpleNamespace(worker_id=r.worker_id,
                                          free=list(r.free),
                                          nt_free=r.nt_free)
                    for r in args[1]]
        t0 = time.perf_counter()
        result = run_tick(*args, **kwargs)
        ms = (time.perf_counter() - t0) * 1e3
        try:
            check_assignments(result, rows, args[2], set())
        except AssertionError as e:
            failures.append(f"tick assignments: {e}")
        assigned["ticks"] += 1
        assigned["tasks"] += len(result)
        assigned["ms"].append(ms)
        if on_tick is not None:
            on_tick(ms)
        return result

    reactor.run_tick = checked_run_tick
    return assigned


def serve_child(server_dir, device, result_path):
    """The server process of the server_start path (spawned; imports only
    the port). Builds `Server(server_dir=, journal_path=server_dir/
    "journal", metrics_port=0)` with every other keyword at its default
    (the default scheduler: GreedyCutScanModel on the card), wraps the
    watchdog's primary in RecordingSeam and the reactor's run_tick in
    check_assignments, then runs what run_server runs: start(), then
    run_until_stopped(). At shutdown it runs Core.sanity_check, reads the
    state of the tasks the parent names in `dropped.json`, keeps each
    job's counters as the journal closes, and after the loop checks that
    every thread the server started has stopped; everything goes to
    `result_path` (JSON) and the recorded solves beside it (pickle)."""
    import pickle
    import threading
    from pathlib import Path

    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.server import reactor
    from hyperqueue_tpu_torch.server.bootstrap import Server
    from hyperqueue_tpu_torch.transport import auth, codec

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    server_dir = Path(server_dir)
    out: dict = {"checks": {}, "failures": [], "times": {},
                 "codec_backend": codec.BACKEND}
    codec_acc = {f"{k}_{s}": 0 for k in ("encode", "decode")
                 for s in ("n", "s", "bytes")}
    lock = threading.Lock()
    auth.pack_payload = _timed(auth.pack_payload, codec_acc, lock, "encode")
    auth.unpack_payload = _timed(auth.unpack_payload, codec_acc, lock,
                                 "decode")
    # the `stop` frames the shutdown encodes for its workers (wall times):
    # how many reach the wire before the connections close 50 ms later
    stops = {"encoded": 0, "first": None, "last": None}
    pack = auth.pack_payload

    def counting_pack(obj):
        data = pack(obj)
        subs = obj.get("msgs", ()) if obj.get("op") == "batch" else (obj,)
        if any(m.get("op") == "stop" for m in subs):
            now = time.time()
            with lock:
                stops["encoded"] += 1
                stops["first"] = stops["first"] or now
                stops["last"] = now
        return data

    auth.pack_payload = counting_pack
    out["stops"] = stops
    assigned = install_tick_check(out["failures"])
    # task messages the reactor drops as stale (unknown task, another
    # instance, already done): none is expected from these workers
    ignored = {"running": 0, "finished": 0, "examples": []}

    def counted(handler, key, core_arg):
        def wrapped(*args, **kwargs):
            core, task_id, instance = args[0], args[core_arg], \
                args[core_arg + 1]
            task = core.tasks.get(task_id)
            if task is None or task.instance_id != instance \
                    or task.is_done:
                ignored[key] += 1
                if len(ignored["examples"]) < 5:
                    ignored["examples"].append(
                        [key, task_id, instance,
                         None if task is None else task.instance_id,
                         None if task is None else task.state.value])
            return handler(*args, **kwargs)
        return wrapped

    reactor.on_task_running = counted(reactor.on_task_running,
                                      "running", 2)
    reactor.on_task_finished = counted(reactor.on_task_finished,
                                       "finished", 3)
    out["ignored"] = ignored
    threads_before = {t.ident for t in threading.enumerate()}

    async def main():
        kwargs = {} if device == "cuda" else {"device": device}
        server = Server(server_dir=server_dir,
                        journal_path=server_dir / "journal",
                        metrics_port=0, **kwargs)
        # the watchdog's primary records every solve's inputs and counts
        recorder = RecordingSeam(server.model.model)
        server.model.model = recorder
        server.model._last_ran = recorder
        out["recorder"] = recorder
        shutdown, close_journal = server.shutdown, server._close_journal

        async def checked_shutdown():
            checks = out["checks"]
            out["times"]["shutdown"] = time.time()
            t0 = time.perf_counter()
            try:
                server.core.sanity_check()
                checks["sanity"] = "ok"
            except Exception as e:  # noqa: BLE001 - reported, fails the run
                checks["sanity"] = repr(e)
            checks["sanity_ms"] = (time.perf_counter() - t0) * 1e3
            checks["dropped"] = dropped_state(server, server_dir)
            checks["watchdog"] = server.model.stats()
            checks["stalls"] = server.stalls_captured
            # the server's whole state is still live here
            out["rss_at_stop_mb"], _ = rss_mb()
            out["times"]["checks"] = time.time()
            await shutdown()
            out["times"]["shutdown_done"] = time.time()

        def checked_close_journal():
            out["close_counters"] = {
                str(jid): dict(job.counters)
                for jid, job in server.jobs.jobs.items()}
            close_journal()
            if server.jplane is not None:
                out["commit_ms"] = server.jplane.commit_ms()
                out["journal_plane"] = server.jplane.stats()

        server.shutdown = checked_shutdown
        server._close_journal = checked_close_journal
        await server.start()
        await server.run_until_stopped()
        out["tick_counter"] = server.core.tick_counter

    asyncio.run(main())
    out["times"]["loop_done"] = time.time()
    deadline = time.monotonic() + 5.0
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if t.ident not in threads_before and t.is_alive())
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    out["longest_stalls"] = longest_stalls(server_dir)
    recorder = out.pop("recorder")
    with open(str(result_path) + ".solves", "wb") as f:
        pickle.dump(recorder.calls, f, protocol=pickle.HIGHEST_PROTOCOL)
    out.update(
        threads_left=left,
        hq_current=(server_dir / "hq-current").is_symlink(),
        solves=len(recorder.calls),
        launches=assign.greedy_cut_scan.launches,
        resident_launches=assign.greedy_cut_scan.resident_launches,
        gang_launches=assign.greedy_cut_scan.gang_launches,
        assigned=assigned, codec=codec_acc, peak_rss_mb=rss_mb()[1])
    out["times"]["written"] = time.time()
    with open(result_path, "w") as f:
        json.dump(out, f)
    # the server has stopped and everything is written: the interpreter's
    # teardown would free the server's multi-GB heap object by object
    # (4 s at the north star); the OS takes it back at once
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def longest_stalls(server_dir, top=6):
    """The longest captured stall of each plane (the server's stall dumps
    under `server_dir`): its seconds, tick, and the stacks its sampling
    profiler took most often in the stall's window (each stack's last
    frames)."""
    from pathlib import Path

    best: dict = {}
    for path in Path(server_dir).rglob("stall-*.json"):
        try:
            dump = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        plane = dump.get("plane")
        if plane not in best or dump["duration_s"] > best[plane]["duration_s"]:
            best[plane] = {
                "duration_s": dump["duration_s"], "tick": dump.get("tick"),
                "stacks": [[r["plane"], r["stack"][-240:], r["active"],
                            r["count"]] for r in dump.get("profile", [])[:top]]}
    return best


def dropped_state(server, server_dir):
    """Where each task the parent names in `dropped.json` (the running and
    queued tasks of the worker it dropped, with their instances) stands
    now: it must have left that worker, and a new dispatch must carry a
    new instance."""
    from hyperqueue_tpu_torch.server.task import TaskState

    path = server_dir / "dropped.json"
    if not path.exists():
        return {"error": "no dropped.json"}
    dropped = json.loads(path.read_text())
    wid = dropped["worker_id"]
    states: dict = {}
    bad = []
    for task_id, instance in dropped["tasks"]:
        task = server.core.tasks.get(task_id)
        if task is None:
            bad.append((task_id, "gone"))
            continue
        states[task.state.value] = states.get(task.state.value, 0) + 1
        on_dropped = (task.state in (TaskState.ASSIGNED, TaskState.RUNNING)
                      and task.assigned_worker == wid)
        if on_dropped or (task.state is not TaskState.READY
                          and not task.is_done
                          and task.instance_id <= instance):
            bad.append((task_id, task.state.value, task.instance_id))
    return {"worker_id": wid, "tasks": len(dropped["tasks"]),
            "states": states, "bad": bad[:10], "n_bad": len(bad)}


class SimWorker:
    """One simulated worker on a `transport/auth` connection: registers,
    starts each compute entry that fits its free resources (the rest
    waits in a backlog ordered by priority, as the worker runtime parks
    tasks), answers task_running at the start and task_finished after a
    service time, answers retracts from the backlog, drops canceled
    tasks, heartbeats every heartbeat_secs and stops on `stop`."""

    def __init__(self, proc, config):
        self.proc = proc
        self.config = config
        self.free = {it["name"]: int(it["sum_size"])
                     for it in config["descriptor"]["items"]}
        self.wid = 0
        self.conn = None
        self.running: dict = {}     # task id -> (instance, amounts)
        self.backlog: list = []     # entries, by priority (desc), FIFO
        self.outbox: list = []
        self.entries = 0
        self.first_compute = None
        self.stopped = False      # told to stop, or dropped
        self.gone = False         # a send found the connection closed
        self.server_uid = None
        # task id -> (instance, variant) of a finish not sent yet: a
        # reattach declares it running, and sends the finish after
        self.unsent: dict = {}

    async def connect(self, access, reattach=None):
        from hyperqueue_tpu_torch.transport import auth

        t0 = time.perf_counter()
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", access.worker_port)
        try:
            self.conn = await auth.do_authentication(
                reader, writer, auth.ROLE_WORKER, auth.ROLE_SERVER,
                access.worker_key_bytes())
            t1 = time.perf_counter()
            register = {"op": "register", "config": self.config}
            if reattach is not None:
                register["reattach"] = reattach
            await self.conn.send(register)
            reply = await self.conn.recv()
        except BaseException:
            # a failed or abandoned attempt leaves no socket behind (the
            # worker runtime's _connect does the same)
            writer.close()
            raise
        if reply.get("op") != "registered":
            raise AssertionError(f"register answered {reply}")
        self.wid = reply["worker_id"]
        self.server_uid = reply.get("server_uid")
        self.reply = reply
        return t1 - t0, time.perf_counter() - t0

    async def reattach(self):
        """The server went away (kill -9): wait for a successor's access
        record in the same server dir, then register again declaring what
        this worker still runs (and the finishes not sent yet) and its
        parked tasks, as the worker runtime does (`reattach`); drop what
        the successor discards (every parked task among it), then read and
        send on the new connection."""
        from pathlib import Path

        from hyperqueue_tpu_torch.utils import serverdir

        proc, old_uid, t0 = self.proc, self.server_uid, time.perf_counter()
        while True:
            if proc.closing or self.stopped:
                return
            try:
                access = serverdir.load_access(Path(proc.server_dir),
                                               retry_secs=0.0)
            except (FileNotFoundError, ValueError, KeyError, TypeError):
                access = None
            if access is None or access.server_uid == old_uid:
                await asyncio.sleep(0.05)
                continue
            running = [{"id": tid, "instance": inst, "variant": var}
                       for tid, (inst, _a, var) in self.running.items()]
            running += [{"id": tid, "instance": inst, "variant": var}
                        for tid, (inst, var) in self.unsent.items()]
            try:
                async with proc.gate:
                    # an attempt is bounded, as the worker runtime bounds
                    # its own (RECONNECT_ATTEMPT_TIMEOUT): in a storm of
                    # reattaches some handshakes stall (PERF.md §7)
                    await asyncio.wait_for(self.connect(access, {
                        "worker_id": self.wid, "server_uid": old_uid,
                        "running": running,
                        "blocked": [{"id": e["id"],
                                     "instance": e["instance"]}
                                    for e in self.backlog]}),
                        REATTACH_ATTEMPT_S)
            except asyncio.TimeoutError:
                proc.attempts_timed_out += 1
                continue
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                await asyncio.sleep(0.1)
                continue
            except Exception as e:  # noqa: BLE001 - reported, fails the run
                proc.errors.append(f"worker {self.wid} reattach: {e!r}")
                return
            break
        dropped = set(self.reply.get("discard") or ())
        for tid in dropped:
            held = self.running.pop(tid, None)
            if held is not None:
                for name, a in held[1]:
                    self.free[name] += a
            self.unsent.pop(tid, None)
        self.outbox = [m for m in self.outbox if m.get("id") not in dropped]
        self.backlog = []
        proc.reattaches.append(time.perf_counter() - t0)
        proc.discarded += len(dropped)
        self.gone = False
        proc.readers.append(asyncio.ensure_future(self.read_loop()))

    def fits(self, amounts):
        return all(self.free.get(name, 0) >= a for name, a in amounts)

    def start(self, entry, amounts):
        for name, a in amounts:
            self.free[name] -= a
        task_id, instance = entry["id"], entry["instance"]
        self.running[task_id] = (instance, amounts,
                                 int(entry.get("variant", 0)))
        self.outbox.append({"op": "task_running", "id": task_id,
                            "instance": instance})
        self.proc.started += 1
        self.proc.loop.call_later(self.proc.service(), self.finish, task_id,
                                  instance)

    def finish(self, task_id, instance):
        if self.stopped:
            return
        held = self.running.get(task_id)
        if held is None or held[0] != instance:
            return  # canceled meanwhile
        del self.running[task_id]
        for name, a in held[1]:
            self.free[name] += a
        self.unsent[task_id] = (instance, held[2])
        self.outbox.append({"op": "task_finished", "id": task_id,
                            "instance": instance})
        self.start_backlog()

    def start_backlog(self):
        if self.proc.frozen:
            return
        kept = []
        for entry in self.backlog:
            amounts = entry["_amounts"]
            if self.fits(amounts):
                self.start(entry, amounts)
            else:
                kept.append(entry)
        self.backlog = kept

    def on_message(self, msg):
        op = msg.get("op")
        if op == "compute":
            now = time.time()
            if self.first_compute is None:
                self.first_compute = now
            for entry in msg["tasks"]:
                self.entries += 1
                self.proc.dispatched.append((entry["id"],
                                             entry["instance"]))
                amounts = [(e["name"], e["amount"])
                           for e in entry["entries"]]
                if not self.proc.frozen and self.fits(amounts):
                    self.start(entry, amounts)
                    continue
                entry["_amounts"] = amounts
                prio = tuple(entry.get("priority") or (0, 0))
                entry["_prio"] = prio
                idx = len(self.backlog)
                while idx > 0 and self.backlog[idx - 1]["_prio"] < prio:
                    idx -= 1
                self.backlog.insert(idx, entry)
        elif op == "retract":
            for task_id, instance in msg["tasks"]:
                before = len(self.backlog)
                self.backlog = [e for e in self.backlog
                                if e["id"] != task_id]
                self.outbox.append({"op": "retract_response", "id": task_id,
                                    "instance": instance,
                                    "ok": len(self.backlog) < before})
                self.proc.retracts += 1
        elif op == "cancel":
            for task_id in msg["task_ids"]:
                self.backlog = [e for e in self.backlog
                                if e["id"] != task_id]
                held = self.running.pop(task_id, None)
                if held is not None:
                    for name, a in held[1]:
                        self.free[name] += a
                self.proc.cancels += 1
        elif op == "stop":
            self.stopped = True
            self.proc.stops += 1
        elif op != "set_overview_override":
            raise AssertionError(f"worker {self.wid}: unexpected {op!r}")

    async def read_loop(self):
        from hyperqueue_tpu_torch.transport import framing

        conn, proc = self.conn, self.proc
        try:
            while not self.stopped:
                raw = await framing.read_frame(conn.reader)
                t0 = time.perf_counter()
                data = conn._opener.open(raw) if conn._opener else raw
                t1 = time.perf_counter()
                frame = framing.unpack_payload(data)
                t2 = time.perf_counter()
                proc.frames_in += 1
                proc.bytes_in += len(raw)
                proc.open_s += t1 - t0
                proc.decode_s += t2 - t1
                msgs = frame["msgs"] if frame.get("op") == "batch" \
                    else [frame]
                for msg in msgs:
                    self.on_message(msg)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self.gone = True
            if proc.server_dir is not None and not self.stopped \
                    and not proc.closing:
                # a worker with `--on-server-lost reconnect`: reattach
                proc.readers.append(proc.loop.create_task(self.reattach()))
            elif not self.stopped and not proc.closing:
                proc.lost.append(self.wid)
        except Exception as e:  # noqa: BLE001 - reported, fails the run
            proc.errors.append(f"worker {self.wid}: {e!r}")
        finally:
            if self.stopped:
                conn.close()

    async def flush(self):
        if not self.outbox or self.conn is None or self.gone:
            return
        msgs, self.outbox = self.outbox, []
        payload = msgs[0] if len(msgs) == 1 else {"op": "batch",
                                                  "msgs": msgs}
        t0 = time.perf_counter()
        data = self.conn.encode(payload)
        self.proc.encode_s += time.perf_counter() - t0
        self.proc.frames_out += 1
        self.proc.bytes_out += len(data)
        try:
            await self.conn.send_bytes(data)
        except (ConnectionError, OSError):
            # the connection went away: a stop, or a loss the read loop
            # reports (a reattaching worker sends these messages after)
            self.gone = True
            self.outbox = msgs + self.outbox
            return
        for m in msgs:
            if m["op"] == "task_finished":
                self.proc.finished += 1
                self.unsent.pop(m["id"], None)


class SimWorkerProc:
    """The simulated workers of one process and its counters."""

    def __init__(self, index, seed, service_s=SERVE_SERVICE_S,
                 server_dir=None):
        self.index = index
        # with a server dir, a worker whose server goes away reattaches to
        # its successor there (SimWorker.reattach); else it counts as lost
        self.server_dir = server_dir
        self.reattaches: list = []    # seconds from the loss to registered
        self.attempts_timed_out = 0
        self.discarded = 0
        # the workers' read loops and reattaches, cancelled at the report
        self.readers: list = []
        self.gate = None
        self.rng = np.random.default_rng([seed, index])
        self.service_s = service_s
        self.loop = None
        self.frozen = False
        self.closing = False
        self.dispatched: list = []
        self.lost: list = []
        self.errors: list = []
        self.started = self.finished = self.retracts = self.cancels = 0
        self.stops = 0
        self.connect_retries = 0
        self.frames_in = self.bytes_in = self.frames_out = self.bytes_out = 0
        self.decode_s = self.open_s = self.encode_s = 0.0

    def service(self):
        return float(self.rng.uniform(*self.service_s))


def serve_worker_proc(index, server_dir, configs, seed, conn,
                      service_s=SERVE_SERVICE_S, reattach=False):
    """A process of simulated workers (spawned; imports only the port's
    transport): connects `configs` to the worker port named by the access
    record, then runs their tasks (each for a time uniform in
    `service_s`) until the parent asks it, over `conn`, to drop its
    busiest worker, to freeze (no more starts or finishes) and to
    report. With `reattach`, a worker whose server goes away reattaches to
    the server that next publishes an access record in `server_dir`."""
    from pathlib import Path

    from hyperqueue_tpu_torch.transport import codec
    from hyperqueue_tpu_torch.utils import serverdir

    proc = SimWorkerProc(index, seed, service_s,
                         server_dir=server_dir if reattach else None)

    async def main():
        proc.loop = asyncio.get_running_loop()
        deadline = time.monotonic() + 120.0
        while True:
            try:
                access = serverdir.load_access(Path(server_dir),
                                               retry_secs=0.0)
                break
            except (FileNotFoundError, ValueError, KeyError, TypeError):
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.02)
        workers = [SimWorker(proc, cfg) for cfg in configs]
        gate = proc.gate = asyncio.Semaphore(SERVE_CONNECT_CONCURRENCY)

        async def connect(w):
            async with gate:
                for attempt in range(SERVE_CONNECT_ATTEMPTS):
                    try:
                        return await w.connect(access)
                    except (asyncio.IncompleteReadError, ConnectionError):
                        if attempt + 1 == SERVE_CONNECT_ATTEMPTS:
                            raise
                        proc.connect_retries += 1
                        await asyncio.sleep(0.2)

        t0 = time.perf_counter()
        times = await asyncio.gather(*(connect(w) for w in workers))
        storm_s = time.perf_counter() - t0
        readers = proc.readers
        readers += [asyncio.ensure_future(w.read_loop()) for w in workers]
        conn.send(("registered", {
            "storm_s": storm_s, "retries": proc.connect_retries,
            "handshake_s": [h for h, _ in times],
            "register_s": [r for _, r in times],
            "worker_ids": [w.wid for w in workers]}))
        commands: asyncio.Queue = asyncio.Queue()
        proc.loop.add_reader(conn.fileno(),
                             lambda: commands.put_nowait(conn.recv()))
        last_beat = time.monotonic()
        beat = min(float(c.get("heartbeat_secs", 8.0)) for c in configs)
        while True:
            try:
                cmd = await asyncio.wait_for(commands.get(), SERVE_FLUSH_S)
            except asyncio.TimeoutError:
                cmd = None
            if time.monotonic() - last_beat >= beat:
                last_beat = time.monotonic()
                for w in workers:
                    if not w.stopped and not w.gone:
                        w.outbox.append({"op": "heartbeat"})
            await asyncio.gather(*(w.flush() for w in workers
                                   if w.outbox and not w.stopped))
            if cmd is None:
                continue
            op = cmd[0]
            if op == "drop":
                victim = max(workers, key=lambda w: (len(w.running), w.wid))
                # a dropped connection loses what was not sent yet: the
                # finishes in its outbox leave those tasks running on the
                # server, so they requeue with the rest
                tasks = [(tid, inst) for tid, (inst, _a, _v)
                         in victim.running.items()]
                tasks += [(m["id"], m["instance"]) for m in victim.outbox
                          if m["op"] == "task_finished"]
                tasks += [(e["id"], e["instance"]) for e in victim.backlog]
                victim.outbox = []
                victim.stopped = True
                victim.conn.close()
                workers.remove(victim)
                conn.send(("dropped", {"worker_id": victim.wid,
                                       "tasks": tasks,
                                       "running": len(victim.running)}))
            elif op == "freeze":
                # no more starts; what runs finishes and is reported
                proc.frozen = True
                deadline = time.monotonic() + proc.service_s[1] + 10.0
                while any(w.running for w in workers) \
                        and time.monotonic() < deadline:
                    await asyncio.sleep(SERVE_FLUSH_S)
                    await asyncio.gather(*(w.flush() for w in workers
                                           if w.outbox and not w.stopped))
                await asyncio.gather(*(w.flush() for w in workers
                                       if w.outbox and not w.stopped))
                conn.send(("frozen", {
                    "finished": proc.finished, "started": proc.started,
                    "running": sum(len(w.running) for w in workers)}))
            elif op == "closing":
                # the server is about to be stopped: a connection that
                # ends from here on is not a lost one
                proc.closing = True
                conn.send(("closing", None))
            elif op == "report":
                proc.closing = True
                ids = np.array([d[0] for d in proc.dispatched],
                               dtype=np.int64)
                inst = np.array([d[1] for d in proc.dispatched],
                                dtype=np.int64)
                firsts = [w.first_compute for w in workers
                          if w.first_compute is not None]
                conn.send(("report", {
                    "codec": codec.BACKEND,
                    "workers": len(workers), "stops": proc.stops,
                    "lost": proc.lost, "errors": proc.errors,
                    "reattaches": proc.reattaches,
                    "attempts_timed_out": proc.attempts_timed_out,
                    "discarded": proc.discarded,
                    "entries": len(proc.dispatched),
                    "ids": ids, "instances": inst,
                    "started": proc.started, "finished": proc.finished,
                    "retracts": proc.retracts, "cancels": proc.cancels,
                    "frames_in": proc.frames_in, "bytes_in": proc.bytes_in,
                    "frames_out": proc.frames_out,
                    "bytes_out": proc.bytes_out,
                    "decode_s": proc.decode_s, "open_s": proc.open_s,
                    "encode_s": proc.encode_s,
                    "first_compute": (min(firsts), max(firsts))
                    if firsts else None}))
                for r in readers:
                    r.cancel()
                for w in workers:
                    if w.conn is not None:
                        w.conn.close()
                return

    asyncio.run(main())


def _pctl(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None


def serve_summary_ticks(records):
    """The server's ticks from the flight recorder's dump: tick 0 (the
    first that placed or prefilled a task), the largest one (most tasks
    placed and prefilled), the median and p99 of the wall ms (the
    `total` phase) and each phase's median over the ticks after tick 0,
    and every tick as [tick, wall ms, placed, prefilled]."""
    ticks = sorted(records, key=lambda r: r["tick"])
    busy = [r for r in ticks if r["counts"]["assigned"]
            + r["counts"]["prefilled"] > 0]
    if not busy:
        return {"ticks": 0}
    t0 = busy[0]
    big = max(busy, key=lambda r: r["counts"]["assigned"]
              + r["counts"]["prefilled"])
    steady = [r for r in ticks if r["tick"] > t0["tick"]]
    totals = [r["phases"].get("total", 0.0) for r in steady]
    names = sorted({k for r in steady for k in r["phases"]})
    return {
        "ticks": len(ticks), "tick0": t0["tick"],
        "tick0_ms": t0["phases"].get("total"),
        "tick0_counts": t0["counts"],
        "largest": big["tick"], "largest_ms": big["phases"].get("total"),
        "largest_phases_ms": big["phases"],
        "largest_counts": big["counts"],
        "steady_ticks": len(steady),
        "steady_median_ms": _pctl(totals, 50),
        "steady_p99_ms": _pctl(totals, 99),
        "steady_phases_median_ms": {
            k: _pctl([r["phases"].get(k, 0.0) for r in steady], 50)
            for k in names},
        "every_tick": [[r["tick"], r["phases"].get("total"),
                        r["counts"]["assigned"], r["counts"]["prefilled"]]
                       for r in ticks],
    }


def lag_p99_by_plane(parsed):
    """hq_reactor_lag_seconds per plane from a parsed scrape: count and
    the upper bucket edge under which 50% and 99% of the observations
    fall."""
    entry = parsed.get("hq_reactor_lag_seconds")
    if not entry:
        return {}
    planes: dict = {}
    for (name, labels), value in entry["samples"].items():
        labels = dict(labels)
        plane = labels.get("plane")
        if name.endswith("_bucket"):
            le = labels["le"]
            edge = float("inf") if le == "+Inf" else float(le)
            planes.setdefault(plane, {"b": []})["b"].append((edge, value))
        elif name.endswith("_count"):
            planes.setdefault(plane, {"b": []})["count"] = value
    out = {}
    for plane, d in planes.items():
        buckets, count = sorted(d["b"]), d.get("count", 0)

        def q(frac):
            for edge, cum in buckets:
                if cum >= frac * count:
                    return None if edge == float("inf") else edge
            return None
        out[plane] = {"count": int(count), "p50_le_s": q(0.5) if count
                      else None, "p99_le_s": q(0.99) if count else None}
    return out


def server_start_path(card, device, n_procs=SERVE_WORKER_PROCS,
                      window_s=SERVE_WINDOW_S, state=None,
                      n_real=SERVE_REAL_WORKERS):
    """Phase 16: the north star through `hq server start`'s process
    boundary. The port's Server runs in a child process (serve_child),
    1,024 simulated workers in `n_procs` processes (serve_worker_proc)
    speak the worker plane over TCP through transport/auth, and the
    client here submits the north star's 200 arrays (1M tasks, lazy above
    the server's lazy_array_threshold) over the client plane (the ingest
    thread), then the workers run tasks for `window_s` seconds. One
    worker drops its connection, the workers drain (no more starts; the
    running tasks finish), the client reads
    server_stats, job_list, job_info, worker_list and the flight recorder,
    the script scrapes /metrics and /readyz, and stop_server follows.
    Every K1 launch of the child is held against its plain version here
    afterwards, and the journal is restored into a fresh Server. Returns
    the path's summary.

    `n_real` of the 1,024 rows (spread over them) run as real port
    workers instead (start_real_worker: `run_worker` with the row's
    configuration and a runner pool of SERVE_REAL_RUNNER_POOL), and run
    their `true` tasks for real (the arrays' bodies ask for no stdout or
    stderr files); they freeze with the simulated ones and report their
    decode, their tasks' stages and their runner restarts (which must be
    0)."""
    import multiprocessing
    import pickle
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from hyperqueue_tpu_torch.transport import codec

    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.server.bootstrap import Server
    from hyperqueue_tpu_torch.transport import auth
    from hyperqueue_tpu_torch.transport.aead import WIRE_BACKEND
    from hyperqueue_tpu_torch.transport.framing import attach_trace
    from hyperqueue_tpu_torch.utils import metrics, serverdir

    t_path = time.perf_counter()
    marks: dict = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_path

    resources, worker_rows, submits, n_tasks = state or journal_state()
    mark("state")
    # the real workers run `true` for real: no output files for 1M tasks
    submits = [dict(d, array=dict(d["array"], body=dict(
        d["array"]["body"], stdout="none", stderr="none")))
        for d in submits]
    all_configs = [cfg.to_wire() for _wid, cfg, _free, _nt in worker_rows]
    real_rows = sorted(set(np.linspace(0, len(all_configs) - 1, n_real)
                           .astype(int).tolist())) if n_real else []
    configs = [c for i, c in enumerate(all_configs) if i not in real_rows]
    real_configs = [dict(all_configs[i], runner_pool=SERVE_REAL_RUNNER_POOL)
                    for i in real_rows]
    tmp = Path(tempfile.mkdtemp(prefix="hq-serve-"))
    server_dir = tmp / "server"
    result_path = tmp / "child.json"
    ctx = multiprocessing.get_context("spawn")
    child = ctx.Process(target=serve_child, name="hq-server",
                        args=(str(server_dir), device.type,
                              str(result_path)))
    procs, pipes, real = [], [], []
    real_results = [tmp / f"real{i:02d}.json" for i in range(len(real_rows))]
    out: dict = {}
    try:
        child.start()
        # the workers' processes start with the server (they wait for its
        # access record), so their imports overlap the server's start
        split = np.array_split(np.arange(len(configs)), n_procs)
        for i, part in enumerate(split):
            parent_end, child_end = ctx.Pipe()
            p = ctx.Process(target=serve_worker_proc, name=f"hq-workers-{i}",
                            args=(i, str(server_dir),
                                  [configs[j] for j in part], SEED,
                                  child_end))
            p.start()
            procs.append(p)
            pipes.append(parent_end)
        t0 = time.perf_counter()
        while True:
            try:
                access = serverdir.load_access(server_dir, retry_secs=0.0)
                break
            except (FileNotFoundError, ValueError, KeyError, TypeError):
                if not child.is_alive():
                    raise AssertionError("server_start: the server child "
                                         f"exited ({child.exitcode})")
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("server_start: no access record")
                time.sleep(0.05)
        out["server_start_s"] = time.perf_counter() - t0
        mark("server_started")
        real = [start_real_worker("row", cfg, server_dir, path)
                for cfg, path in zip(real_configs, real_results)]

        def recv(pipe, what, timeout=120.0):
            if not pipe.poll(timeout):
                raise AssertionError(f"server_start: no {what} from a "
                                     "worker process")
            tag, body = pipe.recv()
            if tag != what:
                raise AssertionError(f"server_start: {tag} for {what}")
            return body

        t0 = time.perf_counter()
        regs = [recv(p, "registered") for p in pipes]
        storm_s = time.perf_counter() - t0
        wait_files([f"{r}.registered" for r in real_results],
                   "server_start: real workers registered", 120.0, real)
        real_ids = [int(Path(f"{r}.registered").read_text())
                    for r in real_results]
        mark("registered")
        handshake = [h for r in regs for h in r["handshake_s"]]
        register = [h for r in regs for h in r["register_s"]]
        out["registration"] = {
            "workers": len(register), "storm_s": storm_s,
            "storm_s_by_process": [r["storm_s"] for r in regs],
            "connect_retries": sum(r["retries"] for r in regs),
            "handshake_ms_p50": _pctl(handshake, 50) * 1e3,
            "handshake_ms_p99": _pctl(handshake, 99) * 1e3,
            "register_rtt_ms_p50": _pctl(register, 50) * 1e3,
            "register_rtt_ms_p99": _pctl(register, 99) * 1e3}
        log("server_start_registration", **out["registration"],
            wire_backend=WIRE_BACKEND, card=card)
        if len({w for r in regs for w in r["worker_ids"]} | set(real_ids)) \
                != len(all_configs):
            raise AssertionError("server_start: worker ids repeat")

        async def client_side():
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", access.client_port)
            conn = await auth.do_authentication(
                reader, writer, auth.ROLE_CLIENT, auth.ROLE_SERVER,
                access.client_key_bytes())

            async def request(msg, timeout=120.0):
                await conn.send(msg)
                return await asyncio.wait_for(conn.recv(), timeout)

            info = await request({"op": "server_info"})
            # the 200 arrays go out back to back (the ingest thread's
            # per-client window holds the rest on the socket) and each
            # ack is timed from its own send; the window runs from the
            # first submit
            sent: list = []
            t_window = t_sub = time.perf_counter()

            async def send_all():
                for i, desc in enumerate(submits):
                    if i:
                        desc = dict(desc, job_id=1)
                    sent.append(time.perf_counter())
                    await conn.send(attach_trace(
                        {"op": "submit", "job": desc}, f"serve{i:04d}",
                        sent_at=time.time()))

            async def read_acks():
                out = []
                for i in range(len(submits)):
                    reply = await asyncio.wait_for(conn.recv(), 300.0)
                    out.append(time.perf_counter() - sent[i])
                    if reply.get("op") != "submit_response":
                        raise AssertionError(f"server_start: submit {i}: "
                                             f"{reply}")
                return out

            _, acks = await asyncio.gather(send_all(), read_acks())
            submit_s = time.perf_counter() - t_sub
            mark("submitted")
            await asyncio.sleep(max(window_s - submit_s, 0.0))
            loop = asyncio.get_running_loop()
            # one worker drops its connection: its tasks must requeue
            pipes[0].send(("drop", None))
            dropped = await loop.run_in_executor(None, recv, pipes[0],
                                                 "dropped")
            (server_dir / "dropped.json").write_text(json.dumps(dropped))
            await asyncio.sleep(2.0)
            for w in real:
                w.send_signal(signal.SIGUSR1)
            for p in pipes:
                p.send(("freeze", None))
            mark("window_end")
            frozen = [await loop.run_in_executor(None, recv, p, "frozen")
                      for p in pipes]
            await loop.run_in_executor(
                None, wait_files, [f"{r}.frozen" for r in real_results],
                "server_start: real workers frozen", 70.0, real)
            real_frozen = [json.loads(Path(f"{r}.frozen").read_text())
                           for r in real_results]
            mark("drained")
            window = time.perf_counter() - t_window
            finished = sum(f["finished"] for f in frozen) \
                + sum(f["finished"] for f in real_frozen)
            # the server works through its backlog of worker frames (and
            # the ticks and fan-out the drain's finishes cause) before its
            # counts reach what the workers sent: tens of seconds here
            t0 = time.perf_counter()
            catch_up = []
            while True:
                job = (await request({"op": "job_info",
                                      "job_ids": [1]}))["jobs"][0]
                done = job["counters"]["finished"]
                if not catch_up or time.perf_counter() - t0 \
                        >= catch_up[-1][0] + 2.0:
                    catch_up.append((round(time.perf_counter() - t0, 1),
                                     done))
                if done >= finished or time.perf_counter() - t0 > 300:
                    break
                await asyncio.sleep(0.2)
            counts_s = time.perf_counter() - t0
            mark("counts_equal")
            stats = await request({"op": "server_stats"})
            job_list = await request({"op": "job_list"})
            workers = await request({"op": "worker_list"})
            flight = await request({"op": "flight_recorder_dump"})
            scrape_text = await loop.run_in_executor(
                None, metrics.scrape, "127.0.0.1", info["metrics_port"])
            ready = await loop.run_in_executor(
                None, metrics.probe, "127.0.0.1", info["metrics_port"],
                "/readyz")
            mark("read")
            for p in pipes:
                p.send(("closing", None))
            for p in pipes:
                await loop.run_in_executor(None, recv, p, "closing")
            t_stop = time.perf_counter()
            t_stop_wall = time.time()
            stop = await request({"op": "stop_server"})
            t_stopped = time.perf_counter()
            conn.close()
            return dict(info=info, acks=acks, submit_s=submit_s,
                        window_s=window, dropped=dropped, frozen=frozen,
                        real_frozen=real_frozen,
                        finished_sent=finished, counts_s=counts_s,
                        catch_up=catch_up, job=job,
                        stats=stats,
                        job_list=job_list, workers=workers, flight=flight,
                        scrape=scrape_text, ready=ready, stop=stop,
                        t_stop=t_stop, t_stop_wall=t_stop_wall,
                        stop_rtt_s=t_stopped - t_stop)

        c = asyncio.run(client_side())
        child.join(SERVE_EXIT_S - (time.perf_counter() - c["t_stop"]))
        exit_s = time.perf_counter() - c["t_stop"]
        mark("child_exited")
        if child.is_alive() or child.exitcode != 0:
            raise AssertionError(f"server_start: the server child did not "
                                 f"exit 0 within {SERVE_EXIT_S} s of "
                                 f"stop_server ({child.exitcode}, "
                                 f"{exit_s:.2f} s)")
        reports = []
        for p in pipes:
            p.send(("report", None))
            reports.append(recv(p, "report"))
        for p in procs:
            p.join(30)
            if p.exitcode != 0:
                raise AssertionError(f"server_start: {p.name} exited "
                                     f"{p.exitcode}")
        for w in real:
            try:
                w.wait(30)
            except subprocess.TimeoutExpired:
                pass
        real_reports = []
        for w, path in zip(real, real_results):
            if w.returncode != 0 or not path.exists():
                tail = Path(f"{path}.log").read_text()[-2000:] \
                    if Path(f"{path}.log").exists() else ""
                raise AssertionError(f"server_start: real worker {path.name}"
                                     f" exited {w.returncode}: {tail}")
            real_reports.append(json.loads(path.read_text()))
        mark("reports")
        res = json.loads(result_path.read_text())
        with open(str(result_path) + ".solves", "rb") as f:
            solves = pickle.load(f)

        # --- checks --------------------------------------------------------
        fails = list(res["failures"])
        if res["checks"].get("sanity") != "ok":
            fails.append(f"Core.sanity_check: {res['checks'].get('sanity')}")
        if res["threads_left"]:
            fails.append(f"server threads left: {res['threads_left']}")
        if res["hq_current"] or (server_dir / "hq-current").is_symlink():
            fails.append("hq-current outlived the server")
        wd = res["checks"]["watchdog"]
        if wd["failures"] or wd["timeouts"] or wd["degraded_ticks"]:
            fails.append(f"watchdog {wd}")
        records = c["flight"].get("ticks") or []
        solvers = {(r["solver"].get("status"), r["solver"].get("backend"))
                   for r in records if r.get("solver")}
        if not any(status == "ok" for status, _b in solvers) or any(
                status not in ("ok", "idle")
                or (status == "ok" and backend != f"device-{device.type}")
                for status, backend in solvers):
            fails.append(f"tick solvers {sorted(solvers, key=str)}")
        if device.type == "cuda" and (
                res["launches"] != res["solves"]
                or res["resident_launches"] != res["solves"]
                or res["gang_launches"] or not res["solves"]):
            fails.append(f"K1 launches {res['launches']} "
                         f"({res['resident_launches']} resident, "
                         f"{res['gang_launches']} gang) for "
                         f"{res['solves']} solves")
        dropped_check = res["checks"]["dropped"]
        if dropped_check.get("n_bad") or dropped_check.get("error") \
                or not dropped_check.get("tasks"):
            fails.append(f"dropped worker's tasks: {dropped_check}")
        real_pairs = np.array([d for r in real_reports
                               for d in r["dispatched"]],
                              dtype=np.int64).reshape(-1, 2)
        ids = np.concatenate([r["ids"] for r in reports] + [real_pairs[:, 0]])
        inst = np.concatenate([r["instances"] for r in reports]
                              + [real_pairs[:, 1]])
        pairs = np.unique(np.stack([ids, inst]), axis=1)
        if pairs.shape[1] != ids.size:
            fails.append(f"{ids.size - pairs.shape[1]} (task, instance) "
                         "pairs dispatched twice")
        moved = {tid: i for tid, i in c["dropped"]["tasks"]}
        redispatched = sum(1 for t, i in zip(ids.tolist(), inst.tolist())
                           if t in moved and i > moved[t])
        if any(f["running"] for f in c["frozen"]):
            fails.append("the workers did not drain: "
                         f"{[f['running'] for f in c['frozen']]}")
        if c["job"]["counters"]["finished"] != c["finished_sent"]:
            fails.append(f"job_info finished "
                         f"{c['job']['counters']['finished']}, the workers "
                         f"finished {c['finished_sent']} "
                         f"({[f['finished'] for f in c['frozen']]}, "
                         f"polled {c['counts_s']:.1f} s; "
                         f"ignored by the reactor {res['ignored']})")
        if res["ignored"]["running"] or res["ignored"]["finished"]:
            fails.append(f"task messages ignored as stale: "
                         f"{res['ignored']}")
        lost = [w for r in reports for w in r["lost"]]
        if lost:
            fails.append(f"workers lost their connection: {lost[:5]}")
        errors = [e for r in reports for e in r["errors"]]
        if errors:
            fails.append(f"simulated workers failed: {errors[:3]}")
        for i, r in enumerate(real_reports):
            fails += real_worker_faults(r, f"real worker {i}")
            if not r.get("finished"):
                fails.append(f"real worker {i} ran no task")
        if any(f["running"] for f in c["real_frozen"]):
            fails.append("the real workers did not drain: "
                         f"{[f['running'] for f in c['real_frozen']]}")
        backends = {"server": res.get("codec_backend"),
                    "simulated": sorted({r.get("codec") for r in reports}),
                    "real": sorted({r.get("codec") for r in real_reports}),
                    "parent": codec.BACKEND}
        if backends["server"] != "native" or backends["parent"] != "native" \
                or set(backends["simulated"]) != {"native"} \
                or set(backends["real"]) - {"native"}:
            fails.append(f"codec backends {backends}")
        # /readyz may answer 503 for a paging SLO alert (a multi-second
        # tick 0 pages tick-latency): every other check must be ok
        ready_checks = c["ready"][1].get("checks", {})
        if c["stop"].get("op") != "ok" or c["ready"][0] not in (200, 503) \
                or any(ready_checks.get(k) != "ok"
                       for k in ("solver", "journal_plane", "ingest")):
            fails.append(f"stop {c['stop']}, readyz {c['ready']}")
        # every K1 launch against its plain version, on the same inputs
        checker = GreedyCutScanModel(device=device.type, backend="device")
        t0 = time.perf_counter()
        for n, (kwargs, counts) in enumerate(solves):
            try:
                check_tick_against_plain(checker, kwargs, counts, device, n)
            except AssertionError as e:
                fails.append(f"solve {n}: {e}")
                break
        plain_check_s = time.perf_counter() - t0
        mark("plain_checked")
        del solves

        # restore the child's journal into a fresh Server
        async def restore():
            kwargs = {} if device.type == "cuda" else {"device": device.type}
            r = Server(server_dir=tmp / "restored",
                       journal_path=server_dir / "journal", **kwargs)
            t0 = time.perf_counter()
            await r._open_journal()
            seconds = time.perf_counter() - t0
            counters = {str(jid): dict(job.counters)
                        for jid, job in r.jobs.jobs.items()}
            r._close_journal()
            r.model.close()
            return counters, seconds, r.last_restore

        # the script's own heap (the earlier paths') frozen out of the
        # collector, as a fresh `hq server start` process would not have it
        gc.collect()
        gc.freeze()
        try:
            counters, restore_s, last_restore = asyncio.run(restore())
        finally:
            gc.unfreeze()
        mark("restored")
        for jid, live in res["close_counters"].items():
            got = counters.get(jid, {})
            if (got.get("finished"), got.get("running")) != (
                    live.get("finished"), live.get("running")):
                fails.append(f"restored job {jid}: {got}, the server "
                             f"closed its journal at {live}")
        if fails:
            raise AssertionError("server_start: " + "; ".join(fails))

        # --- what the run shows -------------------------------------------
        stats = c["stats"]
        ticks = serve_summary_ticks(records)
        window = c["window_s"]
        fan = stats["fanout"]
        firsts = [r["first_compute"] for r in reports if r["first_compute"]]
        codec_server = res["codec"]
        worker_plane = {
            "compute_entries": int(ids.size),
            "frames_in": sum(r["frames_in"] for r in reports),
            "bytes_in": sum(r["bytes_in"] for r in reports),
            "frames_out": sum(r["frames_out"] for r in reports),
            "bytes_out": sum(r["bytes_out"] for r in reports),
            "decode_us_per_frame": sum(r["decode_s"] for r in reports)
            / max(sum(r["frames_in"] for r in reports), 1) * 1e6,
            "decode_us_per_entry": sum(r["decode_s"] for r in reports)
            / max(ids.size, 1) * 1e6,
            "aead_open_us_per_frame": sum(r["open_s"] for r in reports)
            / max(sum(r["frames_in"] for r in reports), 1) * 1e6,
            "encode_us_per_frame": sum(r["encode_s"] for r in reports)
            / max(sum(r["frames_out"] for r in reports), 1) * 1e6,
            "first_compute_spread_s": (max(f[1] for f in firsts)
                                       - min(f[0] for f in firsts))
            if firsts else None,
            "server_fanout": fan,
            "server_encode_us_per_frame": codec_server["encode_s"]
            / max(codec_server["encode_n"], 1) * 1e6,
            "server_encode_bytes_per_frame": codec_server["encode_bytes"]
            / max(codec_server["encode_n"], 1),
            "server_decode_us_per_frame": codec_server["decode_s"]
            / max(codec_server["decode_n"], 1) * 1e6,
            "server_decode_bytes_per_frame": codec_server["decode_bytes"]
            / max(codec_server["decode_n"], 1),
            "server_encode_us_per_kb": codec_server["encode_s"]
            / max(codec_server["encode_bytes"] / 1024, 1e-9) * 1e6,
            "server_encode_s": codec_server["encode_s"],
            "server_decode_s": codec_server["decode_s"],
            "server_frames": {"encoded": codec_server["encode_n"],
                              "decoded": codec_server["decode_n"]},
        }
        lag = lag_p99_by_plane(metrics.parse_exposition(c["scrape"]))
        for i, r in enumerate(real_reports):
            log("server_start_real_worker", index=i, row=real_rows[i],
                **real_worker_line(r), card=card)

        def pooled(key):
            values = [v for r in real_reports for v in r.get(key) or []]
            return {"p50": _pctl(values, 50), "p99": _pctl(values, 99),
                    "n": len(values)}

        real_summary = {
            "workers": len(real_reports),
            "runner_pool": SERVE_REAL_RUNNER_POOL,
            "tasks_run": sum(r["finished"] for r in real_reports),
            "compute_entries": sum(r["entries"] for r in real_reports),
            "decode_us_per_entry": sum(r["decode_s"] for r in real_reports)
            / max(sum(r["entries"] for r in real_reports), 1) * 1e6,
            "parked_ms": pooled("parked_ms"),
            "dispatch_ms": pooled("dispatch_ms"),
            "run_ms": pooled("run_ms"), "total_ms": pooled("total_ms"),
            "runner_restarts": sum(r["runner_restarts"]
                                   for r in real_reports),
            "stops_read": sum(1 for r in real_reports if r["stop_read"])}
        summary = dict(
            workers=len(all_configs), simulated_workers=len(configs),
            real_workers=real_summary, codec_backends=backends,
            worker_processes=n_procs,
            tasks=n_tasks, arrays=len(submits),
            wire_backend=c["info"]["wire_backend"],
            server_start_s=out["server_start_s"],
            registration=out["registration"],
            submit={"arrays": len(c["acks"]), "total_s": c["submit_s"],
                    "ack_ms_p50": _pctl(c["acks"], 50) * 1e3,
                    "ack_ms_p99": _pctl(c["acks"], 99) * 1e3,
                    "ack_ms_max": max(c["acks"]) * 1e3},
            ticks=ticks,
            tick_stats=stats["tick"],
            window_s=window,
            dispatched_per_s=ids.size / window,
            finished_per_s=c["finished_sent"] / window,
            finished=c["finished_sent"],
            # the server's counts behind the drained workers' reports:
            # [seconds after the drain, finished] every 2 s
            counts_caught_up_s=c["counts_s"], catch_up=c["catch_up"],
            worker_plane=worker_plane,
            lag=lag,
            readyz={"status": c["ready"][0], "checks": ready_checks},
            stalls=stats["stalls"]["captured"],
            longest_stalls=res.get("longest_stalls"),
            journal_commits=res.get("commit_ms"),
            journal_plane=res.get("journal_plane"),
            launches=res["launches"], solves=res["solves"],
            tick_solvers=sorted(f"{s}/{b}" for s, b in solvers),
            resident_launches=res["resident_launches"],
            plain_check_s=plain_check_s,
            dropped={"worker_id": c["dropped"]["worker_id"],
                     "tasks": len(c["dropped"]["tasks"]),
                     "running": c["dropped"]["running"],
                     "states_at_stop": dropped_check["states"],
                     "redispatched": redispatched},
            job_counters=c["job"]["counters"],
            sanity_ms=res["checks"]["sanity_ms"],
            exit_s=exit_s, stop_rtt_s=c["stop_rtt_s"],
            child_exit_phases_s={k: v - c["t_stop_wall"]
                                 for k, v in res["times"].items()},
            restore_s=restore_s,
            restore_events=(last_restore or {}).get("tail_events"),
            restore_held=(last_restore or {}).get("held_for_reattach"),
            restored=counters, retracts=sum(r["retracts"] for r in reports),
            stops_received=sum(r["stops"] for r in reports)
            + real_summary["stops_read"],
            # the shutdown's stop frames, encoded by the fan-out before the
            # connections closed (seconds after the shutdown began)
            stops_encoded=res["stops"]["encoded"],
            stops_encoded_s=[None if t is None else t - res["times"]
                             ["shutdown"] for t in (res["stops"]["first"],
                                                   res["stops"]["last"])],
            server_peak_rss_mb=res["peak_rss_mb"],
            server_rss_at_stop_mb=res.get("rss_at_stop_mb"),
            path_phases_s=marks,
            seconds=time.perf_counter() - t_path)
        log("server_start_summary", **summary, card=card)
        return summary
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for w in real:
            if w.poll() is None:
                w.kill()
                w.wait(5)
        if child.is_alive():
            child.kill()
            child.join(5)
        shutil.rmtree(tmp, ignore_errors=True)


def worker_node_path(card, device):
    """Phase 17: the deployment HyperQueue documents, one worker a node
    with the node's detected resources. The port's server in a child
    process (serve_child: the default scheduler, K1 on the card every
    tick) and one port worker (start_real_worker "node": detect_resources,
    every CPU of the machine and the card as `gpus`, the `nvidia-smi`
    count where detection finds none; hwmonitor sampling every
    NODE_OVERVIEW_S; the runner pool at its default width). The client
    submits one array of NODE_TASKS `true` tasks at 1 CPU and one of
    NODE_GPU_TASKS tasks at 1 CPU and `gpus=1`, each running `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader -i
    $HQ_RESOURCE_VALUES_gpus` between two time stamps into its stdout
    file. It fails unless every task finishes within NODE_DRAIN_S of the
    submits and none fails, each GPU task's stdout names the card, no two
    GPU tasks overlap, the worker's overview carries a GPU sample, every
    K1 launch equals its plain version and the codec is native in every
    process. Reports tasks a second, the per-task overhead above a spawn
    floor (a posix_spawn of `true` measured alone here first), the
    worker's uplink frames (every frame it sent, registration included)
    a task and a second of the drain, the runner pool's width and the
    codec backend."""
    import multiprocessing
    import pickle
    import shutil
    import tempfile
    from pathlib import Path

    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.transport import auth, codec
    from hyperqueue_tpu_torch.utils import serverdir

    t_path = time.perf_counter()
    floor = spawn_floor_ms()
    log("worker_node_spawn_floor", **floor, card=card)
    tmp = Path(tempfile.mkdtemp(prefix="hq-node-"))
    server_dir = tmp / "server"
    submit_dir = tmp / "submit"
    submit_dir.mkdir()
    result_path = tmp / "child.json"
    worker_result = tmp / "worker.json"
    ctx = multiprocessing.get_context("spawn")
    child = ctx.Process(target=serve_child, name="hq-server",
                        args=(str(server_dir), device.type,
                              str(result_path)))
    worker = None
    try:
        child.start()
        t0 = time.perf_counter()
        while True:
            try:
                access = serverdir.load_access(server_dir, retry_secs=0.0)
                break
            except (FileNotFoundError, ValueError, KeyError, TypeError):
                if not child.is_alive() or time.perf_counter() - t0 > 120:
                    raise AssertionError("worker_node: no server "
                                         f"({child.exitcode})")
                time.sleep(0.05)
        worker = start_real_worker(f"node:{NODE_OVERVIEW_S}", None,
                                   server_dir, worker_result)
        wait_files([f"{worker_result}.registered"],
                   "worker_node: the worker registered", 120.0, [worker])
        gpu_cmd = ("echo start $(date +%s.%N); nvidia-smi "
                   "--query-gpu=name,power.limit --format=csv,noheader "
                   "-i $HQ_RESOURCE_VALUES_gpus; echo end $(date +%s.%N)")

        def job(name, n, entries, cmd):
            return {"name": name, "submit_dir": str(submit_dir),
                    "array": {"id_range": [0, n], "priority": 0,
                              "request": {"variants": [{"entries": entries}]},
                              "body": {"cmd": cmd, "env": {}, "cwd": None,
                                       "stdout": None, "stderr": None,
                                       "submit_dir": str(submit_dir)}}}

        cpu = {"name": "cpus", "amount": U, "policy": "compact"}
        gpu = {"name": "gpus", "amount": U, "policy": "compact"}

        async def client_side():
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", access.client_port)
            conn = await auth.do_authentication(
                reader, writer, auth.ROLE_CLIENT, auth.ROLE_SERVER,
                access.client_key_bytes())

            async def request(msg, timeout=120.0):
                await conn.send(msg)
                return await asyncio.wait_for(conn.recv(), timeout)

            t_submit = time.perf_counter()
            acks = [await request({"op": "submit", "job": job(
                "true", NODE_TASKS, [cpu], ["true"])}),
                await request({"op": "submit", "job": job(
                    "gpu", NODE_GPU_TASKS, [cpu, gpu],
                    ["bash", "-c", gpu_cmd])})]
            job_ids = [a["job_id"] for a in acks]
            progress, jobs = [], []
            while True:
                jobs = (await request({"op": "job_info",
                                       "job_ids": job_ids}))["jobs"]
                elapsed = time.perf_counter() - t_submit
                done = sum(j["counters"]["finished"] for j in jobs)
                failed = sum(j["counters"].get("failed", 0) for j in jobs)
                if not progress or elapsed >= progress[-1][0] + 5.0:
                    progress.append((round(elapsed, 1), done))
                if done + failed >= NODE_TASKS + NODE_GPU_TASKS \
                        or elapsed > NODE_DRAIN_S:
                    break
                await asyncio.sleep(0.1)
            drain_s = time.perf_counter() - t_submit
            workers = await request({"op": "worker_list"})
            stop = await request({"op": "stop_server"})
            conn.close()
            return dict(acks=acks, jobs=jobs, drain_s=drain_s,
                        progress=progress, workers=workers, stop=stop,
                        done=done, failed=failed)

        c = asyncio.run(client_side())
        child.join(SERVE_EXIT_S)
        try:
            worker.wait(30)
        except subprocess.TimeoutExpired:
            pass
        fails = []
        if c["done"] < NODE_TASKS + NODE_GPU_TASKS:
            fails.append(f"not drained within {NODE_DRAIN_S} s: "
                         f"{c['done']} of {NODE_TASKS + NODE_GPU_TASKS} "
                         f"finished, {c['failed']} failed; progress "
                         f"{c['progress']}")
        if c["failed"]:
            fails.append(f"{c['failed']} tasks failed")
        if child.is_alive() or child.exitcode != 0:
            fails.append(f"the server child did not exit 0 "
                         f"({child.exitcode})")
        if not worker_result.exists():
            tail = Path(f"{worker_result}.log").read_text()[-2000:]
            raise AssertionError(f"worker_node: the worker left no report "
                                 f"({worker.returncode}): {tail}; "
                                 + "; ".join(fails))
        rep = json.loads(worker_result.read_text())
        fails += real_worker_faults(rep, "worker")
        res = json.loads(result_path.read_text())
        if res.get("codec_backend") != "native" or codec.BACKEND != "native":
            fails.append(f"codec backends: server "
                         f"{res.get('codec_backend')}, here {codec.BACKEND}")
        # the GPU tasks: the card's name, one at a time
        name = card.split(",")[0].strip()
        spans = []
        gpu_job = c["acks"][1]["job_id"]
        for i in range(NODE_GPU_TASKS):
            path = submit_dir / f"job-{gpu_job}" / f"{i}.stdout"
            text = path.read_text() if path.exists() else ""
            lines = text.split("\n")
            if name not in text:
                fails.append(f"GPU task {i}'s stdout does not name the "
                             f"card: {text[:200]!r}")
                continue
            start = [ln for ln in lines if ln.startswith("start ")]
            end = [ln for ln in lines if ln.startswith("end ")]
            if start and end:
                spans.append((float(start[0].split()[1]),
                              float(end[0].split()[1])))
        spans.sort()
        overlaps = sum(1 for a, b in zip(spans, spans[1:]) if b[0] < a[1])
        if overlaps or len(spans) != NODE_GPU_TASKS:
            fails.append(f"GPU tasks: {overlaps} overlaps in "
                         f"{len(spans)} spans")
        overview = [w.get("overview") for w in c["workers"]["workers"]]
        gpu_samples = [o["hw"].get("gpus") for o in overview
                       if o and o.get("hw")]
        if not any(gpu_samples):
            fails.append(f"no GPU sample in the worker's overview: "
                         f"{overview}")
        wd = res["checks"]["watchdog"]
        if wd["failures"] or wd["timeouts"] or wd["degraded_ticks"]:
            fails.append(f"watchdog {wd}")
        if device.type == "cuda" and (
                res["launches"] != res["solves"] or not res["solves"]):
            fails.append(f"K1 launches {res['launches']} for "
                         f"{res['solves']} solves")
        with open(str(result_path) + ".solves", "rb") as f:
            solves = pickle.load(f)
        checker = GreedyCutScanModel(device=device.type, backend="device")
        for n, (kwargs, counts) in enumerate(solves):
            try:
                check_tick_against_plain(checker, kwargs, counts, device, n)
            except AssertionError as e:
                fails.append(f"solve {n}: {e}")
                break
        del solves
        if fails:
            raise AssertionError("worker_node: " + "; ".join(fails))
        line = real_worker_line(rep)
        n_all = NODE_TASKS + NODE_GPU_TASKS
        summary = dict(
            resources=rep["resources"], detected_gpus=rep["detected_gpus"],
            gpus_from="detect_gpus" if rep["detected_gpus"]
            else "nvidia-smi -L (detect_gpus found none)",
            tasks=n_all, drain_s=c["drain_s"],
            tasks_per_s=n_all / c["drain_s"], progress=c["progress"],
            uplink_frames_per_task=(rep.get("uplink_frames") or 0) / n_all,
            uplink_frames_per_s=(rep.get("uplink_frames") or 0)
            / c["drain_s"],
            spawn_floor_ms=floor,
            overhead_above_floor_ms={
                "total_p50": line["total_ms"]["p50"] - floor["p50"],
                "run_p50": line["run_ms"]["p50"] - floor["p50"]},
            worker=line, runner_pool=rep["runner_pool"],
            codec_backend=rep["codec"], server_codec=res["codec_backend"],
            gpu_spans_s=[round(b - a, 4) for a, b in spans],
            gpu_sample=next(g for g in gpu_samples if g)[:2],
            launches=res["launches"], solves=res["solves"],
            stop=c["stop"], seconds=time.perf_counter() - t_path)
        log("worker_node_summary", **summary, card=card)
        return summary
    finally:
        if worker is not None and worker.poll() is None:
            worker.kill()
            worker.wait(5)
        if child.is_alive():
            child.kill()
            child.join(5)
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 18: the `hq` command line -------------------------------------------
# `hq submit --array 1-CLI_TASKS --cpus 1 -- true`: one streamed array
# (SubmitStream chunks of the CLI's --chunk-size). The north star's 1M
# until phase 20 joined the script: at 1M, phase 18 took 365 s of the
# script's 1,012 s (`task list 1` 159-169 s), and on a slower host the
# script ran past its 1,200 s limit (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6); 250,000 until phase 21 joined it, when the whole
# script ran 864-993 s on the card and past 1,200 s on a slower host
CLI_TASKS = 100_000
# the small jobs pinned to the real worker: an --each-line array of this
# many lines, a TOML graph with dependencies and one task that fails
CLI_EACH_LINE = 250
# a resource only the real worker declares (`--resource`), one unit a task
CLI_PIN = "cli_pin"
CLI_PIN_UNITS = 64
# a simulated worker's task runs this long (uniform, s): an array of
# tasks of 15-30 minutes, so no simulated task finishes during the phase
# and the array still runs, its backlog waiting on the server, while the
# client reads and cancels it. (With phase 16's 1-6 s, and with 10-40 s,
# the workers' finishes saturate the server's loop: the array is done
# before the reads and every command waits tens of seconds; PERF.md §5.)
CLI_SERVICE_S = (900.0, 1800.0)
# the read commands run in CLI_REPEATS rounds started evenly over a window
# of CLI_WINDOW_S seconds, a round's commands at once (as several users'
# would), and the window lasts until the last of them returns
CLI_WINDOW_S = 10.0
CLI_REPEATS = 3
# a client command's own time limit, `hq journal report`'s, and `hq job
# cancel 1`'s: canceling 955k tasks took 24.7-31.8 s in three runs on the
# card and more than 300 s in one (PERF.md §7)
CLI_COMMAND_S = 300.0
CLI_REPORT_S = 120.0
CLI_CANCEL_S = 900.0
# the server must be gone this long after `hq server stop`
CLI_EXIT_S = 10.0

# A client or worker process of the cli path: `python -m
# hyperqueue_tpu_torch` with the arguments after the report path, which
# writes to that path at exit the modules it loaded that a client or
# worker of the port must not load, and its codec backend, and exits with
# the command's code.
CLI_LAUNCHER = r"""
import json, runpy, sys
report, sys.argv = sys.argv[1], ["hq"] + sys.argv[2:]
code = 0
try:
    runpy.run_module("hyperqueue_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                   else 1)
finally:
    codec = sys.modules.get("hyperqueue_tpu_torch.transport.codec")
    with open(report, "w") as f:
        json.dump({"foreign": sorted(
            m for m in sys.modules if m.split(".")[0] in (
                "torch", "numpy", "jax", "jaxlib", "msgpack",
                "hyperqueue_tpu")),
            "codec": getattr(codec, "BACKEND", None)}, f)
sys.exit(code)
"""

# The server of the cli path: cli_server_main with the result path and the
# `server start ...` arguments.
CLI_SERVER_LAUNCHER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.cli_server_main(sys.argv[2], sys.argv[3:])
"""



def cli_reads(explained):
    """The read commands of the cli path's window: (name, arguments);
    `explained` is a task of job 1 that waits ("1.<id>")."""
    return (
        ("job list", ["job", "list"]),
        ("job info 1", ["job", "info", "1"]),
        ("task list 1", ["task", "list", "1"]),
        ("worker list", ["worker", "list"]),
        ("server stats", ["server", "stats"]),
        ("top --once", ["top", "--once", "--output-mode", "json"]),
        ("task explain", ["task", "explain", explained]),
    )


class BackendRecordingSeam(RecordingSeam):
    """A RecordingSeam that also keeps the backend each solve ran on."""

    def __init__(self, watchdog):
        super().__init__(watchdog)
        self.backends = []

    def solve(self, **kwargs):
        counts = super().solve(**kwargs)
        self.backends.append(getattr(self.watchdog, "last_backend", None))
        return counts


def cli_server_main(result_path, argv):
    """The server of the cli path: `python -m hyperqueue_tpu_torch` with
    `argv` (`server start ...`) in this process, after two hooks: every
    Server the CLI builds gets its watchdog's primary wrapped in a
    BackendRecordingSeam, and the reactor's run_tick is wrapped in
    check_assignments (install_tick_check). The CLI parses the flags and
    builds the Server itself. When it returns (the server stopped), this
    writes what it saw to `result_path` (JSON: K1's launch counts, the
    solves' backends, each job's counters as the journal closed, failed
    checks) and the recorded solves beside it (pickle), then exits with
    the CLI's code."""
    import pickle
    import runpy

    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.server import bootstrap
    from hyperqueue_tpu_torch.transport import codec

    out: dict = {"failures": [], "codec_backend": codec.BACKEND}
    assigned = install_tick_check(out["failures"])
    held: dict = {}
    init = bootstrap.Server.__init__
    close_journal = bootstrap.Server._close_journal

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        recorder = BackendRecordingSeam(self.model.model)
        self.model.model = recorder
        self.model._last_ran = recorder
        held.update(recorder=recorder, server=self)

    def recording_close_journal(self):
        out["close_counters"] = {str(jid): dict(job.counters)
                                 for jid, job in self.jobs.jobs.items()}
        close_journal(self)

    bootstrap.Server.__init__ = recording_init
    bootstrap.Server._close_journal = recording_close_journal
    sys.argv = ["hq", *argv]
    code = 0
    try:
        runpy.run_module("hyperqueue_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    recorder = held.get("recorder")
    calls = recorder.calls if recorder is not None else []
    with open(str(result_path) + ".solves", "wb") as f:
        pickle.dump(calls, f, protocol=pickle.HIGHEST_PROTOCOL)
    out.update(
        code=code, solves=len(calls),
        backends=recorder.backends if recorder is not None else [],
        launches=assign.greedy_cut_scan.launches,
        resident_launches=assign.greedy_cut_scan.resident_launches,
        gang_launches=assign.greedy_cut_scan.gang_launches,
        assigned=assigned,
        watchdog=held["server"].model.stats() if held else None,
        peak_rss_mb=rss_mb()[1])
    with open(result_path, "w") as f:
        json.dump(out, f)
    # as serve_child: the OS takes the server's heap back at once
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


class CliRunner:
    """Runs `python -m hyperqueue_tpu_torch` processes (CLI_LAUNCHER) in
    `work` against `server_dir` and keeps each run: its arguments, exit
    code, wall seconds, stderr and import report."""

    def __init__(self, root, tmp, server_dir):
        self.tmp = tmp
        self.work = tmp / "work"
        self.work.mkdir(parents=True, exist_ok=True)
        self.env = {**os.environ, "HQ_SERVER_DIR": str(server_dir),
                    "PYTHONPATH": root + os.pathsep
                    + os.environ.get("PYTHONPATH", "")}
        self.runs: list = []
        # the read commands run from several threads at once
        self.lock = threading.Lock()

    def argv(self, args):
        with self.lock:
            run = {"args": list(args), "n": len(self.runs)}
            self.runs.append(run)
        run["report"] = self.tmp / f"report-{run['n']:03d}.json"
        return [sys.executable, "-c", CLI_LAUNCHER, str(run["report"]),
                *args], run

    def popen(self, args, name, env=None, **kwargs):
        """A long-lived process (a worker, a streaming submit); its output
        goes to `<name>.log` unless `kwargs` say otherwise; `env` adds to
        the runner's environment."""
        argv, run = self.argv(args)
        kwargs.setdefault("stderr", subprocess.STDOUT)
        env = {**self.env, **(env or {})}
        run["t0"] = time.perf_counter()
        if "stdout" in kwargs:
            proc = subprocess.Popen(argv, env=env, cwd=self.work, **kwargs)
        else:
            with open(self.tmp / f"{name}.log", "wb") as log_f:
                proc = subprocess.Popen(argv, env=env, cwd=self.work,
                                        stdout=log_f, **kwargs)
        run["proc"] = proc
        return proc, run

    def finish(self, run, rc):
        run["rc"] = rc
        run["s"] = time.perf_counter() - run["t0"]

    def __call__(self, *args, timeout=CLI_COMMAND_S, env=None):
        """Runs one command to its end; returns its run (stdout in
        run["out"], a file); `env` adds to the runner's environment."""
        argv, run = self.argv(args)
        out = self.tmp / f"out-{run['n']:03d}.txt"
        run["out"] = out
        run["t0"] = time.perf_counter()
        with open(out, "wb") as f:
            try:
                proc = subprocess.run(argv, env={**self.env, **(env or {})},
                                      cwd=self.work,
                                      stdout=f, stderr=subprocess.PIPE,
                                      timeout=timeout)
                rc, err = proc.returncode, proc.stderr
            except subprocess.TimeoutExpired as e:
                rc, err = "timeout", e.stderr or b""
        self.finish(run, rc)
        run["err"] = err.decode("utf-8", "replace")[-2000:]
        return run

    def faults(self, refusals):
        """Runs that exited otherwise than asked: 0 for all but the
        `refusals` (argument tuples, each to the text its error must
        hold), which must exit non-zero saying so; and every process's
        import report."""
        fails = []
        for run in self.runs:
            args = tuple(run["args"])
            if args in refusals:
                if run.get("rc") in (0, None) or refusals[args] not in \
                        run.get("err", ""):
                    fails.append(f"{' '.join(args)}: rc {run.get('rc')}, "
                                 f"{run.get('err', '')[-300:]!r}")
            elif run.get("expect_rc", 0) != run.get("rc"):
                fails.append(f"{' '.join(args)}: rc {run.get('rc')}, "
                             f"{run.get('err', '')[-300:]!r}")
            if run.get("rc") in ("timeout", "killed"):
                continue  # killed: it wrote no report
            try:
                report = json.loads(run["report"].read_text())
            except (OSError, ValueError):
                fails.append(f"{' '.join(args)}: no import report")
                continue
            run["codec"] = report["codec"]
            if report["foreign"]:
                fails.append(f"{' '.join(args)}: loaded "
                             f"{report['foreign'][:5]}")
            if report["codec"] not in (None, "native"):
                fails.append(f"{' '.join(args)}: codec {report['codec']}")
        return fails


def cli_path(card, device, n_procs=SERVE_WORKER_PROCS, n_tasks=CLI_TASKS,
             n_lines=CLI_EACH_LINE, window_s=CLI_WINDOW_S, state=None):
    """Phase 18: the north star through the port's own command line. The
    server is `python -m hyperqueue_tpu_torch server start --server-dir D
    --journal D/journal` (cli_server_main: every other flag at its
    default, so K1 on the card; `--scheduler cpu` where `device` is the
    CPU), 1,023 simulated workers in `n_procs` processes (serve_worker_proc)
    and one real `hq worker start` with the machine's CPUs and CLI_PIN,
    then every client step is a CLI process (CliRunner): the
    `n_tasks`-task `hq submit`, the small jobs pinned to the real worker, `hq job wait`,
    `hq job cat`, the read commands (cli_reads) CLI_REPEATS times each,
    the refusals, `hq job cancel 1`, `hq server stop`, a restart over the
    journal with `hq job list --all`, `hq journal report` and a second
    stop. Returns the path's summary."""
    import math
    import multiprocessing
    import pickle
    import re
    import shutil
    import tempfile
    from pathlib import Path

    from hyperqueue_tpu_torch.client.cli import build_parser
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.transport import codec

    t_path = time.perf_counter()
    marks: dict = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_path

    # the north star's rows but the first, whose place the real worker takes
    worker_rows = (state or journal_state())[1]
    configs = [cfg.to_wire() for _wid, cfg, _free, _nt in worker_rows][1:]
    mark("state")
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = Path(tempfile.mkdtemp(prefix="hq-cli-"))
    server_dir = tmp / "server"
    journal = server_dir / "journal"
    hq = CliRunner(root, tmp, server_dir)
    sched = [] if device.type == "cuda" else ["--scheduler", "cpu"]
    start_args = ["server", "start", "--server-dir", str(server_dir),
                  "--journal", str(journal), *sched]
    ctx = multiprocessing.get_context("spawn")
    servers, procs, pipes = [], [], []
    worker = None
    out: dict = {}
    refusal = ("server", "start", "--server-dir", str(server_dir),
               "--shards", "2", "--journal", str(journal))
    refusals = {refusal: "--journal cannot be combined with --shards"}

    def start_server(tag):
        """A server process (CLI_SERVER_LAUNCHER); returns it, its result
        path and its launch time."""
        result = tmp / f"{tag}.json"
        log_f = open(tmp / f"{tag}.log", "wb")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", CLI_SERVER_LAUNCHER, root, str(result),
             *start_args], env=hq.env, cwd=hq.work, stdout=log_f,
            stderr=subprocess.STDOUT)
        log_f.close()
        servers.append(proc)
        return proc, result, t0

    def wait_access(proc, t0, tag):
        access = server_dir / "hq-current" / "access.json"
        while not access.exists():
            if proc.poll() is not None:
                raise AssertionError(
                    f"cli: {tag} exited {proc.returncode}: "
                    + (tmp / f"{tag}.log").read_text()[-2000:])
            if time.perf_counter() - t0 > 180:
                raise AssertionError(f"cli: {tag}: no access record")
            time.sleep(0.02)
        return time.perf_counter() - t0

    def stop_server(proc):
        run = hq("server", "stop")
        t0 = time.perf_counter()
        try:
            rc = proc.wait(CLI_EXIT_S)
        except subprocess.TimeoutExpired:
            rc = None
        return {"rc": rc, "exit_s": time.perf_counter() - t0,
                "stop_s": run["s"],
                "hq_current": (server_dir / "hq-current").is_symlink()}

    def recv(pipe, what, timeout=180.0):
        if not pipe.poll(timeout):
            raise AssertionError(f"cli: no {what} from a worker process")
        tag, body = pipe.recv()
        if tag != what:
            raise AssertionError(f"cli: {tag} for {what}")
        return body

    try:
        # --- the server, the workers -------------------------------------
        server, result1, t_launch = start_server("server1")
        wait_run = hq.popen(["server", "wait"], "server-wait")
        split = np.array_split(np.arange(len(configs)), n_procs)
        for i, part in enumerate(split):
            parent_end, child_end = ctx.Pipe()
            p = ctx.Process(target=serve_worker_proc, name=f"hq-workers-{i}",
                            args=(i, str(server_dir),
                                  [configs[j] for j in part], SEED,
                                  child_end, CLI_SERVICE_S))
            p.start()
            procs.append(p)
            pipes.append(parent_end)
        out["access_s"] = wait_access(server, t_launch, "server1")
        wait_proc, wait_info = wait_run
        hq.finish(wait_info, wait_proc.wait(120))
        out["server_wait_s"] = time.perf_counter() - t_launch
        mark("server_started")
        worker, worker_run = hq.popen(
            ["worker", "start", "--resource",
             f"{CLI_PIN}=sum({CLI_PIN_UNITS})"], "worker")
        regs = [recv(p, "registered") for p in pipes]
        run = hq("worker", "wait", str(len(configs) + 1))
        out["worker_wait_s"] = run["s"]
        out["registration_storm_s"] = max(r["storm_s"] for r in regs)
        mark("workers")
        log("cli_server", access_s=out["access_s"],
            server_wait_s=out["server_wait_s"],
            worker_wait_s=out["worker_wait_s"],
            storm_s=out["registration_storm_s"], workers=len(configs) + 1,
            scheduler=sched[-1] if sched else "auto (K1 on the card)",
            card=card)

        # --- the north star as one streamed array --------------------------
        chunk = build_parser().parse_args(
            ["submit", "--", "true"]).chunk_size
        proc, sub_run = hq.popen(
            ["submit", "--array", f"1-{n_tasks}", "--cpus", "1", "--",
             "true"], "submit", stdout=subprocess.PIPE)
        t_sub = sub_run["t0"]
        submitted_s = None
        sub_lines = []
        for line in proc.stdout:
            sub_lines.append(line.decode("utf-8", "replace").rstrip())
            if submitted_s is None and b"submitted" in line:
                submitted_s = time.perf_counter() - t_sub
        hq.finish(sub_run, proc.wait(CLI_COMMAND_S))
        sub_run["err"] = "\n".join(sub_lines[-5:])
        out["submit"] = {"tasks": n_tasks, "to_submitted_line_s":
                         submitted_s, "exit_s": sub_run["s"],
                         "chunk_size": chunk,
                         "chunks": math.ceil(n_tasks / chunk),
                         "line": sub_lines[:1]}
        log("cli_submit", **out["submit"], card=card)
        mark("submitted")

        # --- small jobs pinned to the real worker ---------------------------
        entries = [f"entry-{i:04d}" for i in range(n_lines)]
        (hq.work / "lines.txt").write_text("\n".join(entries) + "\n")
        pin = ["--resource", f"{CLI_PIN}=1", "--priority", "1"]
        graph = "\n".join(
            ['name = "cli-graph"']
            + [f'[[task]]\nid = {i}\npriority = 1\n'
               f'command = ["bash", "-c", "echo graph-{i}"]\n'
               f'deps = {deps}\n[[task.request]]\n'
               f'resources = {{ "cpus" = "1", "{CLI_PIN}" = "1" }}\n'
               for i, deps in enumerate([[], [0], [0], [1, 2]])])
        (hq.work / "graph.toml").write_text(graph)
        t0 = time.perf_counter()
        small = [hq("submit", "--each-line", "lines.txt", *pin, "--",
                    "bash", "-c", "echo $HQ_ENTRY"),
                 hq("job", "submit-file", "graph.toml"),
                 hq("submit", *pin, "--", "bash", "-c", "exit 3")]
        waited = hq("job", "wait", "2-3")
        failing = hq("job", "wait", "4")
        # `hq job wait` exits 1 when a job it waited for failed
        failing["expect_rc"] = 1
        small_s = time.perf_counter() - t0
        cat = hq("job", "cat", "2", "stdout")
        got = sorted(cat["out"].read_text().split())
        out["small"] = {"submit_s": [r["s"] for r in small],
                        "wait_s": waited["s"], "wait_failing_s": failing["s"],
                        "to_done_s": small_s, "cat_s": cat["s"],
                        "cat_lines": len(got),
                        "cat_equal": got == entries}
        log("cli_small_jobs", **out["small"], card=card)
        mark("small_jobs")

        # --- the read commands, the refusals ------------------------------
        # a task of job 1 that waits, for `hq task explain`: the middle
        # one (prefill takes the lowest waiting ids, a freed worker the
        # highest), so that it still waits in the window
        waiting = hq("job", "task-ids", "1", "--filter", "waiting")
        ranges = waiting["out"].read_text().partition(":")[2].strip()
        ids = [int(i) for part in ranges.split(",") if part
               for i in range(int(part.split("-")[0]),
                              int(part.split("-")[-1]) + 1)]
        explained = f"1.{ids[len(ids) // 2] if ids else n_tasks}"
        out["waiting_ids"] = {"s": waiting["s"], "n": len(ids),
                              "ranges": ranges[:200]}
        t_window = time.perf_counter()
        times: dict = {name: [] for name, _a in cli_reads(explained)}
        reads: dict = {}
        with ThreadPoolExecutor(max_workers=CLI_REPEATS * 8) as pool:
            futures = []
            for r in range(CLI_REPEATS):
                time.sleep(max(t_window + r * window_s / CLI_REPEATS
                               - time.perf_counter(), 0.0))
                futures += [(name, pool.submit(hq, *args))
                            for name, args in cli_reads(explained)]
            for name, future in futures:
                run = future.result()
                times[name].append(run["s"])
                reads[name] = run
        hq(*refusal)
        # answered by the idle allocation service
        hq("alloc", "list")
        left = window_s - (time.perf_counter() - t_window)
        if left > 0:
            time.sleep(left)
        out["window_s"] = time.perf_counter() - t_window
        rows = [ln for ln in reads["worker list"]["out"].read_text()
                .splitlines() if re.match(r"^\|\s*\d+\s*\|", ln)]
        explain = reads["task explain"]["out"].read_text().splitlines()
        top = json.loads(reads["top --once"]["out"].read_text())
        out["reads"] = {
            name: {"p50_s": _pctl(ts, 50), "max_s": max(ts),
                   "stdout_bytes": reads[name]["out"].stat().st_size}
            for name, ts in times.items()}
        log("cli_commands", **out["reads"], window_s=out["window_s"],
            worker_list_rows=len(rows), top_workers=top.get("n_workers"),
            waiting_ids=out["waiting_ids"], explain=explain[:2], card=card)
        mark("window")

        # --- cancel and stop ---------------------------------------------
        cancel = hq("job", "cancel", "1", timeout=CLI_CANCEL_S)
        # the journal plane and the loop's lag right after the cancel's
        # O(tasks) work (its records, its cancel frames)
        stats = hq("server", "stats", "--output-mode", "json")
        try:
            after = json.loads(stats["out"].read_text())
        except ValueError:
            after = {}
        out["after_cancel"] = {k: after.get(k) for k in ("journal_plane",
                                                         "lag", "fanout")}
        for p in pipes:
            p.send(("closing", None))
        for p in pipes:
            recv(p, "closing")
        stop1 = stop_server(server)
        mark("stopped")
        reports = []
        for p in pipes:
            p.send(("report", None))
            reports.append(recv(p, "report"))
        for p in procs:
            p.join(30)
        try:
            hq.finish(worker_run, worker.wait(30))
        except subprocess.TimeoutExpired:
            hq.finish(worker_run, "timeout")
        res1 = json.loads(result1.read_text())
        out["stalls"] = longest_stalls(server_dir)
        log("cli_stop", cancel_s=cancel["s"], **stop1,
            close_counters=res1.get("close_counters"),
            after_cancel=out["after_cancel"], longest_stalls=out["stalls"],
            card=card)

        # --- the restore through the CLI ---------------------------------
        server2, result2, t_launch = start_server("server2")
        restore_s = wait_access(server2, t_launch, "server2")
        listing = hq("job", "list", "--all", "--output-mode", "json")
        restored = {str(j["id"]): j["counters"]
                    for j in json.loads(listing["out"].read_text())}
        report_run = hq("journal", "report", str(journal), "--output",
                        str(tmp / "report.html"), timeout=CLI_REPORT_S)
        stop2 = stop_server(server2)
        res2 = json.loads(result2.read_text())
        out["restore"] = {
            "access_s": restore_s, "job_list_s": listing["s"],
            "journal_bytes": journal.stat().st_size,
            "report_s": report_run["s"], "report_rc": report_run["rc"],
            "report_limit_s": CLI_REPORT_S, "stop": stop2}
        if report_run["rc"] == "timeout":
            # the report did not finish inside its limit: how far it got
            # is what it wrote before the limit (nothing, for an HTML page
            # written at its end)
            out["restore"]["report_reached"] = (
                (tmp / "report.html").exists())
            report_run["expect_rc"] = "timeout"
        log("cli_restore", **out["restore"], card=card)
        mark("restored")

        # --- checks --------------------------------------------------------
        fails = hq.faults(refusals)
        fails += [f"server1: {f}" for f in res1["failures"]]
        fails += [f"server2: {f}" for f in res2["failures"]]
        for tag, stop in (("server1", stop1), ("server2", stop2)):
            if stop["rc"] != 0 or stop["hq_current"]:
                fails.append(f"{tag} did not exit 0 within {CLI_EXIT_S} s "
                             f"of hq server stop with hq-current gone: "
                             f"{stop}")
        if not out["small"]["cat_equal"]:
            fails.append(f"job cat 2 stdout: {len(got)} lines, not the "
                         f"{n_lines} entries")
        if len(rows) != len(configs) + 1:
            fails.append(f"worker list: {len(rows)} rows")
        # the array still runs while the client reads it
        if not explain or explain[0].split()[-1] in ("finished", "failed",
                                                     "canceled"):
            fails.append(f"task explain of a waiting task: {explain[:1]}")
        if restored != res1.get("close_counters"):
            fails.append(f"restored job list {restored}, the journal "
                         f"closed at {res1.get('close_counters')}")
        backends = {"server1": res1["codec_backend"],
                    "server2": res2["codec_backend"],
                    "simulated": sorted({r["codec"] for r in reports}),
                    "clients": sorted({str(r.get("codec"))
                                       for r in hq.runs}),
                    "parent": codec.BACKEND}
        if {res1["codec_backend"], res2["codec_backend"], codec.BACKEND} \
                != {"native"} or set(backends["simulated"]) != {"native"}:
            fails.append(f"codec backends {backends}")
        lost = [w for r in reports for w in r["lost"]]
        errors = [e for r in reports for e in r["errors"]]
        if lost or errors:
            fails.append(f"simulated workers: lost {lost[:5]}, "
                         f"errors {errors[:3]}")
        want = f"device-{device.type}"
        for tag, res in (("server1", res1), ("server2", res2)):
            wd = res["watchdog"] or {}
            if wd.get("failures") or wd.get("timeouts") \
                    or wd.get("degraded_ticks"):
                fails.append(f"{tag} watchdog {wd}")
            if set(res["backends"]) - {want} \
                    or len(res["backends"]) != res["solves"]:
                fails.append(f"{tag} solved on "
                             f"{sorted(set(map(str, res['backends'])))}")
            if device.type == "cuda" and (
                    res["launches"] != res["solves"]
                    or res["resident_launches"] != res["solves"]
                    or res["gang_launches"]):
                fails.append(f"{tag}: K1 launches {res['launches']} "
                             f"({res['resident_launches']} resident, "
                             f"{res['gang_launches']} gang) for "
                             f"{res['solves']} solves")
        if not res1["solves"]:
            fails.append("server1 solved nothing")
        checker = GreedyCutScanModel(device=device.type, backend="device")
        t0 = time.perf_counter()
        n_checked = 0
        for result in (result1, result2):
            with open(str(result) + ".solves", "rb") as f:
                solves = pickle.load(f)
            for n, (kwargs, counts) in enumerate(solves):
                try:
                    check_tick_against_plain(checker, kwargs, counts,
                                             device, n)
                except AssertionError as e:
                    fails.append(f"{result.stem} solve {n}: {e}")
                    break
                n_checked += 1
            del solves
        plain_check_s = time.perf_counter() - t0
        mark("checked")
        if fails:
            raise AssertionError("cli: " + "; ".join(fails))
        summary = dict(
            workers=len(configs) + 1, simulated_workers=len(configs),
            worker_processes=n_procs,
            server={k: out[k] for k in ("access_s", "server_wait_s",
                                        "worker_wait_s")},
            submit=out["submit"], small=out["small"], reads=out["reads"],
            window_s=out["window_s"], stop=stop1, restore=out["restore"],
            commands=len(hq.runs), codec_backends=backends,
            launches=res1["launches"] + res2["launches"],
            solves=res1["solves"] + res2["solves"],
            solves_held=n_checked, plain_check_s=plain_check_s,
            assigned={k: res1["assigned"][k] for k in ("ticks", "tasks")},
            # the reactor's run_tick past the first ALLOC_TICK_SKIP ticks,
            # the allocation service running with no queue
            tick_steady_ms_p50=_pctl(
                res1["assigned"]["ms"][ALLOC_TICK_SKIP:], 50),
            tick_steady_ms_p99=_pctl(
                res1["assigned"]["ms"][ALLOC_TICK_SKIP:], 99),
            server_peak_rss_mb=res1.get("peak_rss_mb"),
            path_phases_s=marks, seconds=time.perf_counter() - t_path)
        log("cli_summary", **summary, card=card)
        return summary
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for proc in servers + ([worker] if worker is not None else []) + [
                r["proc"] for r in hq.runs if "proc" in r]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 19: autoalloc ----------------------------------------------------
# the allocation service's pass (HQ_AUTOALLOC_INTERVAL, s) on the server of
# the autoalloc path, and the demand queries it must run before the reads
ALLOC_INTERVAL_S = 0.5
ALLOC_QUERIES = 20
# the path's array: the north star's 1M. With 250,000 the fleet's
# prefill (up to 512 tasks queued a worker) takes every task, the
# server's queues hold no batch, and no demand query solves; with
# 600,000 (and 10 queries) the Slurm queue submitted nothing in 122 s
# before the kill (NVIDIA H100 80GB HBM3, 700.00 W)
ALLOC_TASKS = 1_000_000
# run_tick's steady median leaves out the first ticks (tick 0's prefill)
ALLOC_TICK_SKIP = 5
# the first server dies at the ALLOC_KILL_AT-th `autoalloc.submit` match
# of the Slurm handler: the probe of `alloc add slurm`, its first submit,
# then this one, before its `sbatch` runs
ALLOC_KILL_AT = 3
# how long the path waits for the queries and the local workers, for the
# killed server's exit and for the reattach, and for the removed local
# allocations' process groups to be gone
ALLOC_WAIT_S = 120.0
ALLOC_EXIT_S = 10.0

# The server of the autoalloc path: alloc_server_main with the record path
# and the `server start ...` arguments.
ALLOC_SERVER_LAUNCHER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.alloc_server_main(sys.argv[2], sys.argv[3:])
"""

# stub Slurm binaries (as tests/test_autoalloc.py builds them): `sbatch`
# counts its calls and logs its arguments, `sacct` reports every job
# PENDING, `scancel` logs its arguments
ALLOC_STUB_BINS = {
    "sbatch": """#!/bin/bash
n=$(cat "{log}/counter" 2>/dev/null || echo 0)
n=$((n+1))
echo $n > "{log}/counter"
echo "$@" >> "{log}/sbatch.log"
echo "Submitted batch job $n"
""",
    "sacct": """#!/bin/bash
n=$(cat "{log}/counter" 2>/dev/null || echo 0)
for i in $(seq 1 $n); do echo "$i|PENDING"; done
""",
    "scancel": """#!/bin/bash
echo "$@" >> "{log}/scancel.log"
""",
}


class AllocRecorder:
    """The autoalloc path's server-side record: every tick solve (its
    inputs and counts), every demand query (its assembly's, its solve's and
    its own ms, its solve's inputs and counts, the queries' shapes and its
    answer), each allocation event and each allocation worker's
    registration, appended as pickles to one file and flushed at once, so
    that a server killed by its fault plan leaves what it did behind. Each
    solve record carries K1's launch counts by site and the residency's
    stats as they stood after it. Wraps the watchdog's primary model:
    every attribute but the solves is the model's."""

    def __init__(self, model, path):
        self.model = model
        self.sink = open(path, "ab")
        self.lock = threading.Lock()
        self.query = None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def write(self, record):
        import pickle

        with self.lock:
            pickle.dump(record, self.sink, protocol=pickle.HIGHEST_PROTOCOL)
            self.sink.flush()

    def solve_state(self):
        import torch

        from hyperqueue_tpu_torch.ops import assign

        k1 = assign.greedy_cut_scan
        state = {"t": time.time(), "sites": dict(k1.site_launches),
                 "launches": k1.launches,
                 "resident_launches": k1.resident_launches,
                 "gang_launches": k1.gang_launches,
                 "backend": getattr(self.model, "last_backend", None),
                 "residency": self.model.resident_stats()}
        if torch.cuda.is_initialized():
            state["device_memory"] = {
                "allocated": torch.cuda.memory_allocated(),
                "peak": torch.cuda.max_memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}
        return state

    def tick(self, kwargs, counts):
        self.write({"kind": "tick", "kwargs": kwargs,
                    "counts": np.array(counts, copy=True),
                    **self.solve_state()})

    def solve(self, **kwargs):
        inputs = RecordingSeam._copy(kwargs)
        counts = self.model.solve(**kwargs)
        self.tick(inputs, counts)
        return counts

    def solve_async(self, **kwargs):
        handle = self.model.solve_async(**kwargs)
        inputs, recorder = RecordingSeam._copy(kwargs), self

        class Handle:
            def result(self):
                counts = handle.result()
                recorder.tick(inputs, counts)
                return counts

        return Handle()

    def solve_query(self, **kwargs):
        t0 = time.perf_counter()
        counts = self.model.solve_query(**kwargs)
        # where the query solved (it leaves the model's last_backend, the
        # tick's, as it was)
        backend = "host" if self.model._sticky_host() is True \
            else f"device-{self.model.device.type}"
        self.query = (RecordingSeam._copy(kwargs), np.array(counts),
                      (time.perf_counter() - t0) * 1e3, backend)
        return counts


def alloc_server_main(record_path, argv):
    """The server of the autoalloc path: `python -m hyperqueue_tpu_torch`
    with `argv` (`server start ...`) in this process, after these hooks:
    every Server the CLI builds gets its watchdog's primary wrapped in an
    AllocRecorder writing to `record_path`; the allocation service's
    compute_new_worker_query (and the assembly inside it) are timed and
    recorded; its events and its allocation workers' registrations are
    recorded; the reactor's run_tick is wrapped in check_assignments and
    timed. A server that stops writes an "end" record (the watchdog's
    stats, K1's counts, the residency, misfits); one that its fault plan
    kills writes none. A SIGINT (which ends a standby, the one server
    process no `hq server stop` ends) stops it as a stop does, with the
    CLI's exit code for an interrupt."""
    import runpy

    from hyperqueue_tpu_torch.autoalloc import query as query_mod
    from hyperqueue_tpu_torch.autoalloc import service as service_mod
    from hyperqueue_tpu_torch.server import bootstrap

    failures: list = []
    held: dict = {}
    assigned = install_tick_check(
        failures, on_tick=lambda ms: held["recorder"].write(
            {"kind": "tick_ms", "ms": ms, "t": time.time()}))
    init = bootstrap.Server.__init__
    compute = service_mod.compute_new_worker_query
    assemble = query_mod.assemble_solve_inputs
    emit = service_mod.AutoAllocService.emit
    connected = service_mod.AutoAllocService.on_worker_connected
    slot: dict = {}

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        recorder = AllocRecorder(self.model.model, record_path)
        self.model.model = recorder
        self.model._last_ran = recorder
        held.update(recorder=recorder, server=self)

    def timed_assemble(*args, **kwargs):
        t0 = time.perf_counter()
        out = assemble(*args, **kwargs)
        slot["assemble_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def recorded_query(core, model, queries):
        recorder = held["recorder"]
        recorder.query = None
        slot.clear()
        t0 = time.perf_counter()
        response = compute(core, model, queries)
        record = {
            "kind": "query", "total_ms": (time.perf_counter() - t0) * 1e3,
            "assemble_ms": slot.get("assemble_ms"),
            "max_sn": [q.max_sn_workers for q in queries],
            "min_utilization": [q.min_utilization for q in queries],
            "sn": list(response.single_node_workers_per_query),
            **recorder.solve_state()}
        if recorder.query is not None:
            record.update(kwargs=recorder.query[0],
                          counts=recorder.query[1],
                          solve_ms=recorder.query[2],
                          backend=recorder.query[3])
        recorder.write(record)
        return response

    def recorded_emit(self, kind, payload):
        held["recorder"].write({"kind": "event", "event": kind,
                                "payload": dict(payload), "t": time.time()})
        return emit(self, kind, payload)

    def recorded_connected(self, worker_id, alloc_id):
        held["recorder"].write({"kind": "connected", "worker": worker_id,
                                "alloc": alloc_id, "t": time.time()})
        return connected(self, worker_id, alloc_id)

    bootstrap.Server.__init__ = recording_init
    query_mod.assemble_solve_inputs = timed_assemble
    service_mod.compute_new_worker_query = recorded_query
    service_mod.AutoAllocService.emit = recorded_emit
    service_mod.AutoAllocService.on_worker_connected = recorded_connected
    sys.argv = ["hq", *argv]
    code = 0
    try:
        runpy.run_module("hyperqueue_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except KeyboardInterrupt:
        code = 130
    recorder = held.get("recorder")
    if recorder is not None:
        recorder.write({
            "kind": "end", "code": code, "failures": failures,
            "ticks": assigned["ticks"], "tasks": assigned["tasks"],
            "watchdog": held["server"].model.stats(),
            "peak_rss_mb": rss_mb()[1], **recorder.solve_state()})
        recorder.sink.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def read_records(path):
    """The records an AllocRecorder wrote (a torn last one is dropped)."""
    import pickle

    records = []
    try:
        with open(path, "rb") as f:
            while True:
                try:
                    records.append(pickle.load(f))
                except (EOFError, pickle.UnpicklingError, ValueError,
                        AttributeError, IndexError):
                    break
    except FileNotFoundError:
        pass
    return records


def group_alive(pgid) -> bool:
    """Does a process of the group `pgid` still run (zombies aside)?"""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            return True
    return False


def check_query_against_plain(model, record, n):
    """A recorded query solve through the plain version on the CPU (copies
    of its padded inputs): the counts must agree, and the per-query count
    of fake rows with load (the answer's single_node_workers_per_query,
    every queue here without a utilization floor) must equal the answer."""
    import torch

    case = check_tick_against_plain(model, record["kwargs"],
                                    record["counts"], torch.device("cpu"),
                                    f"query {n}")
    n_b, n_v, n_w = case["_extents"]
    counts = case["_counts"][:n_b, :n_v, :n_w]
    first_fake = n_w - sum(record["max_sn"])
    loaded = counts[:, :, first_fake:].sum(axis=(0, 1)) > 0
    recount, offset = [], 0
    for k in record["max_sn"]:
        recount.append(int(loaded[offset:offset + k].sum()))
        offset += k
    if recount != record["sn"]:
        raise AssertionError(f"query {n}: answered {record['sn']}, the "
                             f"plain counts give {recount}")
    return case


def alloc_path(card, device, n_procs=SERVE_WORKER_PROCS,
               n_tasks=ALLOC_TASKS, state=None):
    """Phase 19: the allocation service of the port's `hq server start`
    beside the tick, its demand query on K1, and a kill -9 by fault plan
    in the middle of a Slurm submit with the restore that reconciles the
    allocations (see the module docstring). Returns the path's summary
    and one padded case of each site (a tick's and a query's) for the
    kernel's timing."""
    import json as json_mod
    import multiprocessing
    import shutil
    import tempfile
    from pathlib import Path

    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

    t_path = time.perf_counter()
    marks: dict = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_path

    worker_rows = (state or journal_state())[1]
    configs = [cfg.to_wire() for _wid, cfg, _free, _nt in worker_rows][1:]
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = Path(tempfile.mkdtemp(prefix="hq-alloc-"))
    server_dir = tmp / "server"
    journal = server_dir / "journal"
    bin_dir, stub_log = tmp / "bin", tmp / "stub-log"
    bin_dir.mkdir()
    stub_log.mkdir()
    for name, body in ALLOC_STUB_BINS.items():
        path = bin_dir / name
        path.write_text(body.format(log=stub_log))
        path.chmod(0o755)
    hq = CliRunner(root, tmp, server_dir)
    hq.env["PATH"] = f"{bin_dir}{os.pathsep}{hq.env.get('PATH', '')}"
    sched = [] if device.type == "cuda" else ["--scheduler", "cpu"]
    start_args = ["server", "start", "--server-dir", str(server_dir),
                  "--journal", str(journal), *sched]
    plan = json_mod.dumps({"rules": [
        {"site": "autoalloc.submit", "op": "slurm", "at": ALLOC_KILL_AT,
         "action": "kill"}]})
    ctx = multiprocessing.get_context("spawn")
    servers, procs, pipes = [], [], []
    groups: list = []
    worker = None
    out: dict = {}

    def start_server(tag, env_extra):
        records = tmp / f"{tag}.rec"
        log_f = open(tmp / f"{tag}.log", "wb")
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-c", ALLOC_SERVER_LAUNCHER, root,
             str(records), *start_args],
            env={**hq.env, "HQ_AUTOALLOC_INTERVAL": str(ALLOC_INTERVAL_S),
                 **env_extra},
            cwd=hq.work, stdout=log_f, stderr=subprocess.STDOUT)
        log_f.close()
        servers.append(proc)
        return proc, records, t0

    def wait_access(proc, t0, tag, before=None):
        access = server_dir / "hq-current" / "access.json"
        while True:
            if access.exists() and (before is None
                                    or access.resolve() != before):
                return time.time() - t0
            if proc.poll() is not None:
                raise AssertionError(
                    f"autoalloc: {tag} exited {proc.returncode}: "
                    + (tmp / f"{tag}.log").read_text()[-2000:])
            if time.time() - t0 > 180:
                raise AssertionError(f"autoalloc: {tag}: no access record")
            time.sleep(0.05)

    def wait_records(path, done, what, proc=None):
        t0 = time.time()
        while True:
            records = read_records(path)
            if done(records):
                return records
            if proc is not None and proc.poll() is not None:
                raise AssertionError(f"autoalloc: the server exited "
                                     f"{proc.returncode} waiting for {what}")
            if time.time() - t0 > ALLOC_WAIT_S:
                raise AssertionError(f"autoalloc: no {what} within "
                                     f"{ALLOC_WAIT_S} s")
            time.sleep(0.25)

    def of(records, kind):
        return [r for r in records if r["kind"] == kind]

    def recv(pipe, what, timeout=180.0):
        if not pipe.poll(timeout):
            raise AssertionError(f"autoalloc: no {what} from a worker "
                                 "process")
        tag, body = pipe.recv()
        if tag != what:
            raise AssertionError(f"autoalloc: {tag} for {what}")
        return body

    def alloc_list():
        run = hq("alloc", "list", "--output-mode", "json")
        return run, {q["id"]: q for q in
                     json_mod.loads(run["out"].read_text())}

    def sbatch_calls():
        path = stub_log / "sbatch.log"
        return len(path.read_text().splitlines()) if path.exists() else 0

    try:
        # --- the server, the workers, the array ---------------------------
        server1, rec1, t1 = start_server("server1", {"HQ_FAULT_PLAN": plan})
        split = np.array_split(np.arange(len(configs)), n_procs)
        for i, part in enumerate(split):
            parent_end, child_end = ctx.Pipe()
            p = ctx.Process(target=serve_worker_proc, name=f"hq-workers-{i}",
                            args=(i, str(server_dir),
                                  [configs[j] for j in part], SEED,
                                  child_end, CLI_SERVICE_S))
            p.start()
            procs.append(p)
            pipes.append(parent_end)
        out["access_s"] = wait_access(server1, t1, "server1")
        first_access = (server_dir / "hq-current" / "access.json").resolve()
        worker, worker_run = hq.popen(
            ["worker", "start", "--on-server-lost", "stop"], "worker")
        for p in pipes:
            recv(p, "registered")
        run = hq("worker", "wait", str(len(configs) + 1))
        out["worker_wait_s"] = run["s"]
        submit = hq("submit", "--array", f"1-{n_tasks}", "--cpus", "1",
                    "--", "true")
        out["submit_s"] = submit["s"]
        log("alloc_server", access_s=out["access_s"],
            worker_wait_s=out["worker_wait_s"], workers=len(configs) + 1,
            submit_s=out["submit_s"], tasks=n_tasks,
            scheduler=sched[-1] if sched else "auto (K1 on the card)",
            interval_s=ALLOC_INTERVAL_S, card=card)
        mark("submitted")

        # --- the local queue: queries, real workers -------------------------
        t_add = time.time()
        hq("alloc", "add", "local", "--backlog", "2", "--workers-per-alloc",
           "2", "--max-worker-count", "4", "--on-server-lost", "reconnect",
           "--worker-args=--cpus", "--worker-args=1")
        records = wait_records(
            rec1, lambda rs: len(of(rs, "query")) >= ALLOC_QUERIES
            and len(of(rs, "connected")) >= 4,
            f"{ALLOC_QUERIES} queries and 4 local workers", server1)
        events = of(records, "event")
        queued = [e for e in events if e["event"] == "alloc-queued"]
        bound = [e for e in events if e["event"] == "alloc-worker-bound"]
        out["add_to_first_submit_s"] = queued[0]["t"] - t_add
        out["add_to_first_worker_s"] = bound[0]["t"] - t_add
        local_ids = sorted({e["payload"]["alloc"] for e in queued})
        mark("local_queue")

        # --- the reads -----------------------------------------------------
        reads = {}
        run, listed = alloc_list()
        reads["alloc list"] = run["s"]
        for name, args in (
                ("alloc info", ("alloc", "info", "1")),
                ("alloc events", ("alloc", "events", "--output-mode",
                                  "json")),
                ("alloc log", ("alloc", "log", local_ids[0], "stdout"))):
            run = hq(*args)
            reads[name] = run["s"]
            if name == "alloc events":
                decisions = json_mod.loads(run["out"].read_text())
        log("alloc_reads", **{k: round(v, 3) for k, v in reads.items()},
            queue_state=listed[1]["state"],
            local_allocations=[(a["id"], a["status"], len(a["workers"]))
                               for a in listed[1]["allocations"]],
            verdicts=sorted({d["verdict"] for d in decisions}), card=card)
        mark("reads")

        # --- the Slurm queue, and the kill in its second submit --------------
        for p in pipes:
            p.send(("closing", None))
        for p in pipes:
            recv(p, "closing")
        t_slurm = time.time()
        hq("alloc", "add", "slurm", "--backlog", "4", "--workers-per-alloc",
           "16", "--time-limit", "1h")
        try:
            rc1 = server1.wait(ALLOC_WAIT_S)
        except subprocess.TimeoutExpired:
            rc1 = "timeout"
        t_killed = time.time()
        records1 = read_records(rec1)
        sbatch_at_kill = sbatch_calls()
        slurm_before = sorted(
            e["payload"]["alloc"] for e in of(records1, "event")
            if e["event"] == "alloc-queued" and e["payload"]["queue_id"] == 2)
        log("alloc_kill", rc=rc1, after_slurm_add_s=t_killed - t_slurm,
            sbatch_calls=sbatch_at_kill, slurm_allocations=slurm_before,
            queries=len(of(records1, "query")), card=card)
        for p in pipes:
            p.send(("report", None))
        reports = [recv(p, "report") for p in pipes]
        for p in procs:
            p.join(5)
        # the real worker stops with its server (--on-server-lost stop);
        # its exit code is not this path's question
        try:
            hq.finish(worker_run, worker.wait(5))
        except subprocess.TimeoutExpired:
            worker.kill()
            worker.wait(5)
            hq.finish(worker_run, "killed")
        worker_run["expect_rc"] = worker_run.get("rc")
        mark("killed")

        # --- the restore: reattach and reconcile ----------------------------
        server2, rec2, t2 = start_server("server2", {})
        restore_s = wait_access(server2, t2, "server2", before=first_access)
        records2 = wait_records(
            rec2, lambda rs: len({r["worker"] for r in of(rs, "connected")
                                  if r["alloc"] in local_ids}) >= 4,
            "the 4 local workers' reattach", server2)
        reattached = [r for r in of(records2, "connected")
                      if r["alloc"] in local_ids]
        out["reconcile_s"] = max(r["t"] for r in reattached) - t2
        # the Slurm queue fills its backlog again; then the table is read
        wait_records(rec2, lambda rs: len(
            [e for e in of(rs, "event") if e["event"] == "alloc-queued"
             and e["payload"]["queue_id"] == 2]) + len(slurm_before) >= 4,
            "the Slurm backlog", server2)
        run, listed2 = alloc_list()
        local2 = listed2[1]["allocations"]
        slurm2 = listed2[2]["allocations"]
        out["restore"] = {
            "access_s": restore_s, "reconcile_s": out["reconcile_s"],
            "local": [(a["id"], a["status"], sorted(a["workers"]))
                      for a in local2],
            "slurm": [(a["id"], a["status"]) for a in slurm2],
            "sbatch_calls": sbatch_calls()}
        log("alloc_restore", **out["restore"], card=card)
        mark("restored")

        # --- remove the queues, stop ---------------------------------------
        groups = [int(a["id"].split("-", 1)[1]) for a in local2
                  if a["id"].startswith("local-")]
        t_remove = time.time()
        remove = hq("alloc", "remove", "1")
        while any(group_alive(g) for g in groups) \
                and time.time() - t_remove < ALLOC_EXIT_S:
            time.sleep(0.02)
        out["remove_to_exit_s"] = time.time() - t_remove
        left = [g for g in groups if group_alive(g)]
        hq("alloc", "remove", "2")
        stop = hq("server", "stop")
        try:
            rc2 = server2.wait(CLI_EXIT_S)
        except subprocess.TimeoutExpired:
            rc2 = "timeout"
        records2 = read_records(rec2)
        log("alloc_remove", remove_s=remove["s"],
            remove_to_exit_s=out["remove_to_exit_s"], groups=groups,
            groups_left=left, stop_s=stop["s"], rc=rc2, card=card)
        mark("removed")

        # --- checks --------------------------------------------------------
        fails = hq.faults(set())
        if rc1 != -9:
            fails.append(f"server1 exited {rc1}, not killed by its plan")
        if rc2 != 0:
            fails.append(f"server2 exited {rc2}")
        end2 = of(records2, "end")
        if not end2:
            fails.append("server2 wrote no end record")
        else:
            fails += [f"server2: {f}" for f in end2[-1]["failures"]]
            wd = end2[-1]["watchdog"]
            if wd.get("failures") or wd.get("timeouts") \
                    or wd.get("degraded_ticks"):
                fails.append(f"server2 watchdog {wd}")
        if sbatch_at_kill != ALLOC_KILL_AT - 1:
            fails.append(f"{sbatch_at_kill} sbatch calls at the kill, not "
                         f"{ALLOC_KILL_AT - 1}")
        if sorted(a["id"] for a in local2) != local_ids:
            fails.append(f"local allocations {[a['id'] for a in local2]} "
                         f"after the restore, {local_ids} before")
        if any(len(a["workers"]) != 2 or a["status"] != "running"
               for a in local2):
            fails.append(f"local allocations not reattached: "
                         f"{out['restore']['local']}")
        slurm_ids = [a["id"] for a in slurm2]
        if len(set(slurm_ids)) != len(slurm_ids) \
                or len(slurm_ids) != sbatch_calls() - 1 \
                or not set(slurm_before) <= set(slurm_ids):
            fails.append(f"Slurm allocations {slurm_ids} for "
                         f"{sbatch_calls()} sbatch calls (one the probe), "
                         f"{slurm_before} before the kill")
        if left:
            fails.append(f"local allocation groups {left} still run "
                         f"{ALLOC_EXIT_S} s after alloc remove")
        lost = [w for r in reports for w in r["lost"]]
        errors = [e for r in reports for e in r["errors"]]
        if lost or errors:
            fails.append(f"simulated workers: lost {lost[:5]}, "
                         f"errors {errors[:3]}")
        # on the card every solve runs K1; a rehearsal on the CPU runs
        # `--scheduler cpu`, whose solves run K1's plain version
        want = ("device-cuda",) if device.type == "cuda" else (
            "device-cpu",)
        checker = GreedyCutScanModel(device=device.type, backend="device")
        t0 = time.perf_counter()
        n_ticks = n_queries = 0
        cases = {}
        sites = {"tick": 0, "alloc_query": 0}
        for tag, recs in (("server1", records1), ("server2", records2)):
            ticks = of(recs, "tick")
            solved = [r for r in of(recs, "query") if "kwargs" in r]
            for r in ticks + solved:
                if not str(r["backend"]).startswith(want):
                    fails.append(f"{tag}: a solve ran on {r['backend']}")
                    break
            # K1's counts by site as each record saw them: the queries'
            # equal the query solves so far; the ticks' the tick solves
            # read so far, or one more while a pipelined tick's solve was
            # dispatched and not yet read
            n_tick = n_query = 0
            last = {}
            for r in recs:
                n_tick += r["kind"] == "tick"
                n_query += r["kind"] == "query" and "kwargs" in r
                if "sites" not in r:
                    continue
                last = r
                if device.type == "cuda" and (
                        r["sites"]["alloc_query"] != n_query
                        or not 0 <= r["sites"]["tick"] - n_tick <= 1):
                    fails.append(f"{tag}: K1 launches by site "
                                 f"{r['sites']} after {n_tick} tick and "
                                 f"{n_query} query solves")
                    break
            for name, r in (("tick", ticks[-1] if ticks else None),
                            ("query", solved[-1] if solved else None)):
                if r is not None and r["residency"]["invalidations"]:
                    fails.append(f"{tag}: the residency was invalidated "
                                 f"({r['residency']})")
            if device.type == "cuda":
                sites["tick"] += last.get("sites", {}).get("tick", 0)
                sites["alloc_query"] += last.get("sites", {}).get(
                    "alloc_query", 0)
            for n, r in enumerate(ticks):
                try:
                    case = check_tick_against_plain(
                        checker, r["kwargs"], r["counts"], device, n)
                except AssertionError as e:
                    fails.append(f"{tag} tick {n}: {e}")
                    break
                # the kernel is timed at the widest tick and query
                if case["_extents"][2] >= cases.get(
                        "tick", {"_extents": (0, 0, 0)})["_extents"][2]:
                    cases["tick"] = case
                n_ticks += 1
            for n, r in enumerate(solved):
                try:
                    case = check_query_against_plain(checker, r, n)
                except AssertionError as e:
                    fails.append(f"{tag}: {e}")
                    break
                if case["_extents"][2] >= cases.get(
                        "query", {"_extents": (0, 0, 0)})["_extents"][2]:
                    cases["query"] = case
                n_queries += 1
        plain_check_s = time.perf_counter() - t0
        if not n_queries or "tick" not in cases:
            fails.append(f"{n_queries} query solves and "
                         f"{n_ticks} ticks held")
        mark("checked")
        if fails:
            raise AssertionError("autoalloc: " + "; ".join(fails))

        queries = of(records1, "query") + of(records2, "query")
        solved = [q for q in queries if "kwargs" in q]
        ticks_ms = [r["ms"] for r in of(records1, "tick_ms")]
        out["queries"] = {
            "run": len(queries), "solved": len(solved),
            "rows": sorted({int(q["kwargs"]["free"].shape[0])
                            for q in solved}),
            "total_ms_p50": _pctl([q["total_ms"] for q in queries], 50),
            "total_ms_max": max(q["total_ms"] for q in queries),
            "assemble_ms_p50": _pctl([q["assemble_ms"] for q in solved], 50),
            "solve_ms_p50": _pctl([q["solve_ms"] for q in solved], 50),
            "solve_ms_max": max(q["solve_ms"] for q in solved)}
        log("alloc_queries", **out["queries"], card=card)
        summary = dict(
            workers=len(configs) + 1, tasks=n_tasks,
            access_s=out["access_s"], submit_s=out["submit_s"],
            queries=out["queries"],
            add_to_first_submit_s=out["add_to_first_submit_s"],
            add_to_first_worker_s=out["add_to_first_worker_s"],
            tick_steady_ms_p50=_pctl(ticks_ms[ALLOC_TICK_SKIP:], 50),
            tick_steady_ms_p99=_pctl(ticks_ms[ALLOC_TICK_SKIP:], 99),
            ticks=len(ticks_ms), kill_rc=rc1, restore=out["restore"],
            remove_to_exit_s=out["remove_to_exit_s"],
            launches_by_site=sites, ticks_held=n_ticks,
            queries_held=n_queries, plain_check_s=plain_check_s,
            path_phases_s=marks, seconds=time.perf_counter() - t_path)
        log("alloc_summary", **summary, card=card)
        return summary, cases
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for proc in servers + ([worker] if worker is not None else []) + [
                r["proc"] for r in hq.runs if "proc" in r]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)
        for g in groups:
            try:
                os.killpg(g, 9)
            except (ProcessLookupError, PermissionError):
                pass
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 20: the deterministic simulator ------------------------------------

# the hash seed of the simulator's child processes: a few str-set orders
# in the server follow it, so two processes agree only under one seed
SIM_HASH_SEED = "0"
# the soak: one uniform array of 20 s tasks over 1,000 workers of 4 CPUs,
# a server kill at 30 s and six worker kills, each worker back after 2 s;
# 15,000 tasks (the simulator's acceptance scale is 100,000, whose soak
# took 75-136 s of wall time on the card's host, too long for the script)
SIM_SOAK_TASKS = 15_000
SIM_SOAK_WORKERS = 1_000
SIM_SOAK_WORKER_KILLS = ((1, 12.0), (7, 18.0), (13, 44.0), (200, 51.0),
                         (400, 60.0), (650, 70.0))
# the entry point's own run, once, for its JSON line
SIM_CLI_ARGS = ["--scheduler", "greedy", "--workload", "bursty",
                "--workers", "64", "--tasks", "3000", "--json",
                "--no-bisect"]
# the time limit of each of the phase's child processes
SIM_CHILD_S = 900.0


class SimSolveRecorder:
    """For the length of a `with`: counts the solves the simulator's
    servers hand to K1 (`GreedyCutScanModel._kernel_dispatch` at the tick
    site) and keeps the widest one (most padded workers, then most steps):
    its inputs, copied to the host before the kernel updates free/nt_free
    in place, and the kernel's counts, free and nt_free."""

    def __init__(self):
        self.solves = 0
        self.widest = None  # (key, case, (counts, free, nt_free))

    def __enter__(self):
        from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

        orig = GreedyCutScanModel._kernel_dispatch
        self._orig = orig
        rec = self

        def dispatch(model, free_d, nt_d, life_d, total_d, inputs,
                     site="tick"):
            if site != "tick":
                return orig(model, free_d, nt_d, life_d, total_d, inputs,
                            site=site)
            rec.solves += 1
            n_b, n_v = inputs["min_time"].shape
            key = (int(free_d.shape[0]), int(n_b * n_v))
            keep = rec.widest is None or key > rec.widest[0]
            if keep:
                case = {"free": free_d, "nt_free": nt_d, "lifetime": life_d,
                        "total": total_d, **inputs}
                case = {k: v.cpu().numpy().copy() for k, v in case.items()
                        if v is not None}
            counts = orig(model, free_d, nt_d, life_d, total_d, inputs,
                          site=site)
            if keep:
                rec.widest = (key, case, tuple(
                    t.cpu().numpy().copy() for t in (counts, free_d, nt_d)))
            return counts

        GreedyCutScanModel._kernel_dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

        GreedyCutScanModel._kernel_dispatch = self._orig
        return False


def sim_device_solves(result) -> int:
    """Decision records, of every incarnation, whose solve ran on the card."""
    return sum(1 for d in result.decisions
               if isinstance(d.get("solver"), dict)
               and str(d["solver"].get("backend", "")).startswith("device"))


def sim_run(device, tag, make, scheduler, failures, **kwargs):
    """One simulation in this process: `make()` gives (workload, faults,
    workers); the scenario runs under `scheduler` on `device` with K1's
    counts set to 0 just before and read just after. Under `greedy` every
    solve must have launched K1 once at the tick site (on the card) and be
    one recorded decision; device memory must be back at its level from
    before. Returns (result, info)."""
    import torch

    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.sim import run_scenario

    wl, faults, workers = make()
    gc.collect()
    on_card = device.type == "cuda"
    mem_before = torch.cuda.memory_allocated() if on_card else 0
    assign.reset_launch_counts()
    with SimSolveRecorder() as rec:
        res = run_scenario(wl, seed=faults.seed, n_workers=workers,
                           faults=faults, scheduler=scheduler,
                           device=str(device), **kwargs)
    launches = assign.greedy_cut_scan.site_launches["tick"]
    gc.collect()
    mem_after = torch.cuda.memory_allocated() if on_card else 0
    info = {
        "run": tag, "scheduler": scheduler, "workload": res.workload,
        "n_tasks": res.n_tasks, "finished": res.audit["finished"],
        "executions": res.audit["executions"],
        "server_boots": res.server_boots,
        "makespan_virtual_s": res.makespan, "wall_s": res.wall_s,
        "virtual_tasks_per_wall_s": res.virtual_tasks_per_wall_s,
        "decisions": len(res.decisions),
        "device_solves_recorded": sim_device_solves(res),
        "solves_dispatched": rec.solves, "k1_tick_launches": launches,
        "memory_allocated_before": mem_before,
        "memory_allocated_after": mem_after,
        "journal_digest": res.journal_digest[:16],
        "decision_digest": res.decision_digest[:16],
    }
    if res.audit["finished"] != wl.n_tasks:
        failures.append(f"{tag}: {res.audit['finished']} of {wl.n_tasks} "
                        "tasks finished")
    if mem_after != mem_before:
        failures.append(f"{tag}: device memory {mem_before} B before, "
                        f"{mem_after} B after")
    if scheduler == "greedy":
        if not rec.solves or rec.solves != info["device_solves_recorded"]:
            failures.append(f"{tag}: {rec.solves} solves dispatched to K1, "
                            f"{info['device_solves_recorded']} recorded")
        if on_card and launches != rec.solves:
            failures.append(f"{tag}: {launches} K1 launches at the tick "
                            f"site for {rec.solves} solves")
    elif rec.solves:
        failures.append(f"{tag}: {rec.solves} solves reached K1 under "
                        f"{scheduler}")
    return res, info, rec


def sim_soak_faults(pkg):
    events = [pkg.FaultEvent(at=30.0, kind="server_kill", delay=2.0)]
    for i, t in SIM_SOAK_WORKER_KILLS:
        events.append(pkg.FaultEvent(
            at=t, kind="worker_kill", target=f"w{i % SIM_SOAK_WORKERS}",
            delay=2.0))
    return pkg.FaultSchedule(seed=1, events=events)


def sim_soak_child(scheduler, device, result_path, case_path,
                   n_tasks=SIM_SOAK_TASKS, n_workers=SIM_SOAK_WORKERS):
    """The soak in a process of its own (spawned with SIM_HASH_SEED, so
    its journal is comparable with its twin's): uniform, `n_tasks` tasks
    of 20 s, `n_workers` workers of 4 CPUs, schedule_min_delay 0.5, the
    server kill at 30 s and the worker kills, seed 1. Writes the result,
    K1's tick launches and the solves (dispatched, recorded), run_tick's
    percentiles and device memory to `result_path` (JSON), and under
    `greedy` the widest solve's inputs and outputs to `case_path` (npz)."""
    import torch

    from hyperqueue_tpu_torch import sim
    from hyperqueue_tpu_torch.ops import assign

    logging.basicConfig(level=logging.ERROR, stream=sys.stderr)
    device = torch.device(device)
    on_card = device.type == "cuda"
    out: dict = {"scheduler": scheduler, "failures": []}
    try:
        if on_card:
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated() if on_card else 0
        wl = sim.build("uniform", seed=1, n_tasks=n_tasks, dur_ms=20_000)
        assign.reset_launch_counts()
        with SimSolveRecorder() as rec:
            res = sim.run_scenario(
                wl, seed=1, n_workers=n_workers, worker_cpus=4,
                faults=sim_soak_faults(sim), horizon=4 * 3600.0,
                schedule_min_delay=0.5, scheduler=scheduler,
                device=str(device))
        launches = assign.greedy_cut_scan.site_launches["tick"]
        gc.collect()
        tick_ms = res.tick_ms
        out.update({
            "n_tasks": res.n_tasks, "n_workers": n_workers,
            "audit": res.audit, "server_boots": res.server_boots,
            "makespan_virtual_s": res.makespan, "wall_s": res.wall_s,
            "virtual_tasks_per_wall_s": res.virtual_tasks_per_wall_s,
            "decisions": len(res.decisions),
            "device_solves_recorded": sim_device_solves(res),
            "solves_dispatched": rec.solves, "k1_tick_launches": launches,
            "run_tick_ms": {"n": len(tick_ms), "p50": _pctl(tick_ms, 50),
                            "p95": _pctl(tick_ms, 95),
                            "p99": _pctl(tick_ms, 99),
                            "max": max(tick_ms) if tick_ms else None},
            "journal_digest": res.journal_digest,
            "decision_digest": res.decision_digest,
            "memory_allocated_before": mem_before,
            "memory_allocated_after": torch.cuda.memory_allocated()
            if on_card else 0,
            "max_memory_allocated": torch.cuda.max_memory_allocated()
            if on_card else 0,
            "rss_mb": rss_mb(),
        })
        if rec.widest is not None:
            key, case, (counts, free, nt) = rec.widest
            np.savez(case_path, **case, _kernel_counts=counts,
                     _kernel_free=free, _kernel_nt_free=nt)
            out["widest"] = {"padded_w": key[0], "steps": key[1],
                             "shape": list(counts.shape)}
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        import traceback

        out["failures"].append(f"{type(e).__name__}: {e}")
        out["traceback"] = traceback.format_exc()[-4000:]
    with open(result_path, "w") as f:
        json.dump(out, f)


def sim_hold_widest(case_path, device):
    """The soak's widest recorded solve through the plain version on the
    card: counts, free and nt_free must equal what K1 gave in the run.
    Returns the case with the plain counts under "_counts"."""
    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan_reference

    with np.load(case_path) as z:
        case = {k: z[k] for k in z.files}
    got = [case.pop(k) for k in ("_kernel_counts", "_kernel_free",
                                 "_kernel_nt_free")]
    args, opt = _args(to_device(case, device))
    ref = [t.cpu().numpy() for t in greedy_cut_scan_reference(*args, **opt)]
    for name, a, b in zip(("counts", "free", "nt_free"), got, ref):
        if not np.array_equal(a, b):
            raise AssertionError(f"the soak's widest K1 solve differs from "
                                 f"the plain version on {name}")
    case["_counts"] = ref[0]
    return case


def sim_path(card, device, n_tasks=SIM_SOAK_TASKS,
             n_workers=SIM_SOAK_WORKERS):
    """Phase 20: the port's simulator (`hyperqueue_tpu_torch/sim/`), the
    real server on the virtual clock with kill -9 and restore, under
    `--scheduler greedy` (K1 on the card at every tick) beside its host
    twin `greedy-numpy`. Returns the phase's summary, with K1's launches
    and the soak's widest recorded solve (a case for kernel_timing)."""
    import multiprocessing
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from hyperqueue_tpu_torch import sim
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.sim.harness import without_backend
    from hyperqueue_tpu_torch.sim.replay import replay_compare

    t_phase = time.perf_counter()
    failures: list = []
    launches: dict = {}
    work = Path(tempfile.mkdtemp(prefix="hq-sim-phase-"))
    # the servers' warnings (a requeue per task a kill strands) stay out
    # of this process's output, as the simulator's command line keeps them
    quiet = {name: logging.getLogger(name).level
             for name in ("hq", "hyperqueue_tpu_torch")}
    for name in quiet:
        logging.getLogger(name).setLevel(logging.ERROR)
    root = os.path.dirname(os.path.abspath(__file__))
    procs: list = []
    cli = None
    try:
        # the soak (greedy and its greedy-numpy twin) and the entry point,
        # each in a process of its own under one hash seed, started
        # together; this process runs the smaller scenarios meanwhile
        ctx = multiprocessing.get_context("spawn")
        prev_seed = os.environ.get("PYTHONHASHSEED")
        os.environ["PYTHONHASHSEED"] = SIM_HASH_SEED
        try:
            for sched in ("greedy", "greedy-numpy"):
                p = ctx.Process(
                    target=sim_soak_child, name=f"hq-sim-soak-{sched}",
                    args=(sched, str(device), str(work / f"{sched}.json"),
                          str(work / f"{sched}.npz"), n_tasks, n_workers))
                p.start()
                procs.append(p)
        finally:
            if prev_seed is None:
                os.environ.pop("PYTHONHASHSEED", None)
            else:
                os.environ["PYTHONHASHSEED"] = prev_seed
        env = dict(os.environ, PYTHONHASHSEED=SIM_HASH_SEED,
                   PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cli_args = list(SIM_CLI_ARGS)
        if device.type != "cuda":
            cli_args += ["--device", "cpu"]
        t_cli = time.perf_counter()
        cli = subprocess.Popen(
            [sys.executable, "-m", "hyperqueue_tpu_torch.sim", *cli_args],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        # the determinism pair: twice under greedy, once under greedy-numpy
        def pair():
            wl = sim.build("bursty", seed=42, n_tenants=3,
                           bursts_per_tenant=2, tasks_per_burst=80,
                           window=25)
            faults = sim.FaultSchedule(seed=42, events=[
                sim.FaultEvent(at=5.0, kind="server_kill", delay=1.0),
                sim.FaultEvent(at=11.0, kind="worker_kill", target="w3",
                               delay=1.0)])
            return wl, faults, 12

        runs = {}
        for tag, sched in (("pair_greedy_1", "greedy"),
                           ("pair_greedy_2", "greedy"),
                           ("pair_numpy", "greedy-numpy")):
            res, info, _rec = sim_run(device, tag, pair, sched, failures)
            runs[tag] = res
            launches[tag] = info["k1_tick_launches"]
            log("sim_run", **info, card=card)
        a, b, c = runs["pair_greedy_1"], runs["pair_greedy_2"], \
            runs["pair_numpy"]
        pair_checks = {
            "greedy_decisions_equal": a.decision_digest == b.decision_digest,
            "greedy_journals_equal": a.journal_digest == b.journal_digest,
            "journal_equals_numpy": a.journal_digest == c.journal_digest,
            "audit_equals_numpy": a.audit == c.audit,
            "decisions_equal_numpy_but_backend":
                without_backend(a.decisions) == without_backend(c.decisions),
            "two_boots": a.server_boots == c.server_boots == 2,
        }
        backends = sorted({(d["solver"].get("backend"),
                            d["solver"].get("backend_reason"))
                           for r in (a, c) for d in r.decisions
                           if isinstance(d.get("solver"), dict)
                           and "backend" in d["solver"]})
        log("sim_determinism", **pair_checks, backends=backends,
            decision_digests=[r.decision_digest[:16] for r in (a, b, c)],
            journal_digests=[r.journal_digest[:16] for r in (a, b, c)],
            card=card)
        failures += [f"determinism pair: {k}" for k, ok in pair_checks.items()
                     if not ok]
        del runs, a, b, c

        # the sweep: dag, gang and tail under generated faults (seed 7,
        # rate 0.03, one server kill), each under greedy and greedy-numpy
        gang_dir = work / "gang"
        sweep = {}
        for name, kwargs, workers in (
                ("dag", dict(layers=8, width=16), 8),
                ("gang", dict(n_gangs=6, gang_size=3, filler_tasks=300), 12),
                ("tail", dict(n_tasks=800), 12)):
            def make(name=name, kwargs=kwargs, workers=workers):
                names = [f"w{i}" for i in range(workers)]
                return (sim.build(name, seed=7, **kwargs),
                        sim.FaultSchedule.generate(
                            7, horizon=40.0, worker_names=names, rate=0.03,
                            server_kills=1), workers)

            got = {}
            for sched in ("greedy", "greedy-numpy"):
                extra = {"server_dir": gang_dir} \
                    if name == "gang" and sched == "greedy" else {}
                res, info, _rec = sim_run(device, f"sweep_{name}_{sched}",
                                          make, sched, failures, **extra)
                if sched == "greedy":
                    launches[f"sweep_{name}"] = info["k1_tick_launches"]
                log("sim_run", **info, card=card)
                got[sched] = res
            same = got["greedy"].journal_digest == \
                got["greedy-numpy"].journal_digest
            sweep[name] = {"journal_equal": same,
                           "boots": got["greedy"].server_boots}
            if not same:
                failures.append(f"sweep {name}: greedy's journal differs "
                                "from greedy-numpy's")
        log("sim_sweep", **sweep, card=card)

        # replay_compare of the gang run's journal, greedy-numpy against
        # greedy: the same makespan and the same assignments
        assign.reset_launch_counts()
        with SimSolveRecorder() as rec:
            cmp_res = replay_compare(gang_dir / "journal.bin",
                                     "greedy-numpy", "greedy", seed=7,
                                     n_workers=12, device=str(device))
        launches["replay"] = assign.greedy_cut_scan.site_launches["tick"]
        replay = {"makespan_a": cmp_res.makespan_a,
                  "makespan_b": cmp_res.makespan_b,
                  "assigned_a": cmp_res.assigned_a,
                  "assigned_b": cmp_res.assigned_b,
                  "ticks_a": cmp_res.ticks_a, "ticks_b": cmp_res.ticks_b,
                  "solves_dispatched": rec.solves,
                  "k1_tick_launches": launches["replay"],
                  "summary": cmp_res.summary()}
        log("sim_replay_compare", **replay, card=card)
        if (cmp_res.makespan_a != cmp_res.makespan_b
                or cmp_res.assigned_a != cmp_res.assigned_b
                or not cmp_res.assigned_a):
            failures.append(f"replay_compare: {cmp_res.summary()}")
        if device.type == "cuda" and launches["replay"] != rec.solves:
            failures.append(f"replay_compare: {launches['replay']} K1 "
                            f"launches for {rec.solves} solves")
        in_process_s = time.perf_counter() - t_phase

        # the entry point's JSON line
        try:
            out, err = cli.communicate(timeout=SIM_CHILD_S)
        except subprocess.TimeoutExpired:
            cli.kill()
            out, err = cli.communicate()
            failures.append("the entry point did not finish in "
                            f"{SIM_CHILD_S:.0f} s")
        cli_wall = time.perf_counter() - t_cli
        lines = out.strip().splitlines()
        try:
            row = json.loads(lines[-1])
        except (IndexError, ValueError):
            row = {}
        log("sim_entry_point", argv=["python", "-m",
                                     "hyperqueue_tpu_torch.sim", *cli_args],
            returncode=cli.returncode, process_wall_s=cli_wall, result=row,
            stderr_tail=err[-1500:] if cli.returncode else "", card=card)
        if cli.returncode != 0 or row.get("audit", {}).get("finished") \
                != row.get("n_tasks"):
            failures.append(f"the entry point: rc {cli.returncode}, "
                            f"{row.get('audit')}")

        # the soak pair
        soak = {}
        for p in procs:
            p.join(SIM_CHILD_S)
            if p.is_alive():
                p.kill()
                p.join()
                failures.append(f"{p.name} did not finish in "
                                f"{SIM_CHILD_S:.0f} s")
        for sched in ("greedy", "greedy-numpy"):
            path = work / f"{sched}.json"
            soak[sched] = json.loads(path.read_text()) \
                if path.exists() else {"failures": ["no result"]}
            r = soak[sched]
            failures += [f"soak {sched}: {f}" for f in r.get("failures", ())]
            log("sim_soak", **{k: v for k, v in r.items()
                               if k not in ("failures",)}, card=card)
        g, h = soak["greedy"], soak["greedy-numpy"]
        soak_checks = {
            "greedy_all_finished":
                g.get("audit", {}).get("finished") == n_tasks,
            "numpy_all_finished":
                h.get("audit", {}).get("finished") == n_tasks,
            "two_boots": g.get("server_boots") == h.get("server_boots") == 2,
            "journals_equal": g.get("journal_digest") is not None
            and g.get("journal_digest") == h.get("journal_digest"),
            "audits_equal": g.get("audit") == h.get("audit"),
            "launches_equal_solves_recorded":
                g.get("solves_dispatched") == g.get("device_solves_recorded")
                and (device.type != "cuda"
                     or g.get("k1_tick_launches")
                     == g.get("solves_dispatched")),
            "memory_back": g.get("memory_allocated_after")
            == g.get("memory_allocated_before"),
        }
        failures += [f"soak: {k}" for k, ok in soak_checks.items() if not ok]
        launches["soak"] = g.get("k1_tick_launches", 0)
        widest = None
        case_path = work / "greedy.npz"
        if case_path.exists():
            widest = sim_hold_widest(case_path, device)
        else:
            failures.append("soak: no widest solve recorded")
        summary = {"checks": {"determinism": pair_checks, "sweep": sweep,
                              "soak": soak_checks},
                   "launches": launches,
                   "launches_total": sum(launches.values()),
                   "in_process_s": in_process_s,
                   "seconds": time.perf_counter() - t_phase}
        log("sim_summary", **summary, failures=failures, card=card)
        if failures:
            raise AssertionError(f"sim path: {failures}")
        return summary, widest, soak
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.communicate()
        shutil.rmtree(work, ignore_errors=True)
        for name, level in quiet.items():
            logging.getLogger(name).setLevel(level)


# -- phase 21: the federation -------------------------------------------------
# the tasks of each shard's array (`hq submit --array 1-N`, one cpu each):
# job 1 on shard 0, job 2 on shard 1; each simulated task runs this long
# (uniform, s), so that both arrays still run when job 1 moves and shard 1
# dies, and the phase drains within FED_BUDGET_S
FED_TASKS = 10_000
FED_SERVICE_S = (3.0, 6.0)
# `--lease-timeout` of the shards and the standby, s
FED_LEASE_S = 2
# simulated worker processes for each shard
FED_PROCS_PER_SHARD = 2
# a simulated worker's reattach attempt is abandoned (and made again)
# after this many seconds
REATTACH_ATTEMPT_S = 2.0
# the limits of the drain after the kill, of a server's exit after `hq
# server stop` (and the standby's after its SIGINT), and the phase's budget
FED_DRAIN_S = 120.0
FED_EXIT_S = 15.0
FED_BUDGET_S = 60.0


def federation_path(card, device, n_tasks=FED_TASKS, service_s=FED_SERVICE_S,
                    state=None):
    """Phase 21: the deployment the port documents for a federation, through
    `python -m hyperqueue_tpu_torch`: two shard processes (`server start
    --server-dir ROOT --shards 2 --shard-id K --lease-timeout 2`) and one
    `--standby --no-coordinator`, each through ALLOC_SERVER_LAUNCHER (every
    solve streamed to a file, so the shard that is killed leaves its solves
    behind); the north star's 1,024 worker rows split across the shards:
    simulated workers (serve_worker_proc, FED_PROCS_PER_SHARD processes a
    shard), 511 to shard 0 and 512 to shard 1, which reattach to a
    successor, and one real `worker start --shard 0`. One array of
    `n_tasks` is submitted to each shard from the root (`HQ_SHARD`); `job
    list`, `fleet status` and `top --once --output-mode json` read the
    root with both shards up; `fleet migrate 1 1` moves job 1 to shard 1,
    and shard 1 is killed with SIGKILL. The standby claims its lease
    (epoch 2), restores it over its journal and the workers reattach; the
    jobs drain. Checks: every task finished exactly once by `job list
    --all` and by the two shard journals' `task-finished` records, `server
    info --shard all` shows the epochs (1 and 2) and the promotion, `server
    stop` at the root stops both servers (the standby then exits on
    SIGINT), every solve of each process ran on `device` and, on the card,
    K1's launches equal each process's solves, resident, and every solve
    equals the plain version. Logs the steps' seconds (`federation_*`), the
    time from the kill to the first task the successor finished, and the
    device memory of each process. Returns the path's summary."""
    import multiprocessing
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from hyperqueue_tpu_torch.events.journal import Journal
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.utils import serverdir

    t_path = time.perf_counter()
    marks: dict = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t_path, 3)

    worker_rows = (state or journal_state())[1]
    configs = [cfg.to_wire() for _wid, cfg, _free, _nt in worker_rows]
    # the real worker takes the first row's place on shard 0
    half = len(configs) // 2
    shard_configs = {0: configs[1:half], 1: configs[half:]}
    mark("state")
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = Path(tempfile.mkdtemp(prefix="hq-fed-"))
    root = tmp / "root"
    hq = CliRunner(repo, tmp, root)
    sched = [] if device.type == "cuda" else ["--scheduler", "cpu"]
    lease = ["--lease-timeout", str(FED_LEASE_S)]
    ctx = multiprocessing.get_context("spawn")
    servers: dict = {}
    procs, pipes = [], []
    worker = None
    out: dict = {}

    def shard_dir(k):
        return serverdir.shard_path(root, k)

    def start(tag, args):
        record = tmp / f"{tag}.rec"
        log_f = open(tmp / f"{tag}.log", "wb")
        proc = subprocess.Popen(
            [sys.executable, "-c", ALLOC_SERVER_LAUNCHER, repo, str(record),
             "server", "start", "--server-dir", str(root), *args, *lease,
             *sched], env=hq.env, cwd=hq.work, stdout=log_f,
            stderr=subprocess.STDOUT)
        log_f.close()
        servers[tag] = (proc, record)

    def wait_for(what, ready, timeout, step=0.02):
        t0 = time.perf_counter()
        while not ready():
            for tag, (proc, _r) in servers.items():
                if proc.poll() is not None and tag not in out.get(
                        "ended", ()):
                    raise AssertionError(
                        f"federation: {tag} exited {proc.returncode} "
                        f"waiting for {what}: "
                        + (tmp / f"{tag}.log").read_text()[-2000:])
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"federation: no {what} in "
                                     f"{timeout} s")
            time.sleep(step)
        return time.perf_counter() - t0

    def recv(pipe, what, timeout=180.0):
        if not pipe.poll(timeout):
            raise AssertionError(f"federation: no {what} from a worker "
                                 "process")
        tag, body = pipe.recv()
        if tag != what:
            raise AssertionError(f"federation: {tag} for {what}")
        return body

    def json_out(run):
        return json.loads(run["out"].read_text())

    def access_of(k):
        return (shard_dir(k) / "hq-current" / "access.json").exists()

    def lease_epoch(k):
        try:
            return json.loads((shard_dir(k) / "lease.json").read_text())[
                "epoch"]
        except (OSError, ValueError, KeyError):
            return None

    try:
        # --- the shards, the standby, the workers ---------------------------
        t0 = time.perf_counter()
        for k in (0, 1):
            start(f"shard{k}", ["--shards", "2", "--shard-id", str(k)])
        start("standby", ["--standby", "--no-coordinator"])
        for k, cfgs in shard_configs.items():
            for part in np.array_split(np.arange(len(cfgs)),
                                       FED_PROCS_PER_SHARD):
                parent_end, child_end = ctx.Pipe()
                p = ctx.Process(
                    target=serve_worker_proc,
                    name=f"hq-fed-workers-{k}-{len(procs)}",
                    args=(len(procs), str(shard_dir(k)),
                          [cfgs[j] for j in part], SEED, child_end,
                          service_s, k == 1))
                p.start()
                procs.append(p)
                pipes.append(parent_end)
        out["access_s"] = wait_for("shard access records",
                                   lambda: access_of(0) and access_of(1),
                                   180)
        worker, worker_run = hq.popen(
            ["worker", "start", "--shard", "0"], "worker")
        regs = [recv(p, "registered") for p in pipes]
        waited = [hq("worker", "wait", str(len(shard_configs[0]) + 1),
                     env={"HQ_SERVER_DIR": str(shard_dir(0))}),
                  hq("worker", "wait", str(len(shard_configs[1])),
                     env={"HQ_SERVER_DIR": str(shard_dir(1))})]
        out["workers_s"] = time.perf_counter() - t0
        mark("workers")
        log("federation_start", access_s=out["access_s"],
            workers_s=out["workers_s"],
            workers={k: len(c) + (k == 0) for k, c in shard_configs.items()},
            storm_s=max(r["storm_s"] for r in regs),
            worker_wait_s=[w["s"] for w in waited],
            scheduler=sched[-1] if sched else "auto (K1 on the card)",
            card=card)

        # --- one array to each shard, the reads at the root -----------------
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=3) as pool:
            subs = [pool.submit(hq, "submit", "--array", f"1-{n_tasks}",
                                "--cpus", "1", "--", "true",
                                env={"HQ_SHARD": str(k)}) for k in (0, 1)]
            subs = [f.result() for f in subs]
        submitted = [r["out"].read_text().strip() for r in subs]
        out["submit_s"] = time.perf_counter() - t0
        mark("submitted")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=3) as pool:
            reads = {name: pool.submit(hq, *args) for name, args in (
                ("job list", ["job", "list", "--output-mode", "json"]),
                ("fleet status", ["fleet", "status"]),
                ("top --once", ["top", "--once", "--output-mode", "json"]))}
            reads = {name: f.result() for name, f in reads.items()}
        out["reads_s"] = time.perf_counter() - t0
        listed = sorted(j["id"] for j in json_out(reads["job list"]))
        status = reads["fleet status"]["out"].read_text()
        top = json_out(reads["top --once"])
        log("federation_reads", submit_s=out["submit_s"],
            submitted=submitted, reads_s=out["reads_s"],
            each_s={n: r["s"] for n, r in reads.items()}, jobs=listed,
            fleet_status=status.splitlines()[:4],
            top_up=sorted(k for k, v in top.get("shards", {}).items()
                          if v is not None), card=card)
        mark("reads")

        # --- the migration, the kill, the failover, the drain ---------------
        migrate = hq("fleet", "migrate", "1", "1")
        moved = migrate["out"].read_text().strip()
        mark("migrated")
        killed_at = time.time()
        t_kill = time.perf_counter()
        servers["shard1"][0].kill()
        servers["shard1"][0].wait(10)
        out.setdefault("ended", []).append("shard1")
        promote_s = wait_for("promotion (lease epoch 2)",
                             lambda: lease_epoch(1) == 2, 60)
        promoted_access_s = wait_for(
            "the successor's access record", lambda: access_of(1), 60)
        mark("promoted")

        def drained():
            run = hq("job", "list", "--all", "--output-mode", "json")
            if run["rc"] != 0:
                # a read while the successor boots may fail; the drain's
                # end is read again below
                run["expect_rc"] = run["rc"]
                return False
            jobs = json_out(run)
            return len(jobs) == 2 and all(
                j["counters"]["finished"] + j["counters"]["failed"]
                + j["counters"]["canceled"] == n_tasks for j in jobs)

        wait_for("drain", drained, FED_DRAIN_S, step=0.5)
        drain_s = time.perf_counter() - t_kill
        mark("drained")
        final = json_out(hq("job", "list", "--all", "--output-mode", "json"))
        info = json_out(hq("server", "info", "--shard", "all",
                           "--output-mode", "json"))
        fed_info = [r.get("federation") or {} for r in info.get("shards", [])]

        # --- the stop -------------------------------------------------------
        for p in pipes:
            p.send(("closing", None))
        for p in pipes:
            recv(p, "closing")
        t0 = time.perf_counter()
        stop = hq("server", "stop")
        exits = {}
        try:
            exits["shard0"] = servers["shard0"][0].wait(FED_EXIT_S)
        except subprocess.TimeoutExpired:
            exits["shard0"] = None
        out["ended"].append("shard0")
        # the promoted server retires its lease at a clean stop
        try:
            wait_for("the successor's stop",
                     lambda: not (shard_dir(1) / "lease.json").exists(),
                     FED_EXIT_S)
            exits["successor"] = 0
        except AssertionError:
            exits["successor"] = None
        standby = servers["standby"][0]
        standby.send_signal(signal.SIGINT)
        out["ended"].append("standby")
        try:
            exits["standby"] = standby.wait(FED_EXIT_S)
        except subprocess.TimeoutExpired:
            exits["standby"] = None
        stop_s = time.perf_counter() - t0
        reports = []
        for p in pipes:
            p.send(("report", None))
            reports.append(recv(p, "report"))
        for p in procs:
            p.join(30)
        try:
            hq.finish(worker_run, worker.wait(30))
        except subprocess.TimeoutExpired:
            hq.finish(worker_run, "timeout")
        mark("stopped")

        # --- checks ---------------------------------------------------------
        fails = hq.faults({})
        if listed != [1, 2]:
            fails.append(f"job list at the root: {listed}")
        if "ownership epoch" not in status or "shard 1:" not in status:
            fails.append(f"fleet status: {status[:300]!r}")
        if sorted(top.get("shards", {})) != ["0", "1"] or any(
                v is None for v in top["shards"].values()):
            fails.append(f"top --once at the root: shards "
                         f"{ {k: v is not None for k, v in top.get('shards', {}).items()} }")
        if not all(f"job ID: {k + 1}" in submitted[k] for k in (0, 1)):
            fails.append(f"submits: {submitted}")
        if "migrated job 1: shard 0 -> 1" not in moved:
            fails.append(f"fleet migrate: {moved!r}")
        for j in final:
            c = j["counters"]
            if c["finished"] != n_tasks or c["failed"] or c["canceled"]:
                fails.append(f"job {j['id']} ended {c}")
        epochs = [(f.get("shard_id"), f.get("lease_epoch"),
                   f.get("promoted")) for f in fed_info]
        if epochs != [(0, 1, False), (1, 2, True)]:
            fails.append(f"server info --shard all: {epochs}")
        # (the CLI answers an interrupt with 130)
        if stop["rc"] != 0 or exits != {"shard0": 0, "successor": 0,
                                        "standby": 130}:
            fails.append(f"server stop: rc {stop['rc']}, exits {exits}")
        # every task finished exactly once across both journals (job 1's
        # finishes before the move on shard 0, after it on shard 1; job 2's
        # over both of shard 1's incarnations)
        finishes: dict = {1: {}, 2: {}}
        first_after: float | None = None
        for k in (0, 1):
            boots = 0
            for rec in Journal.read_all(shard_dir(k) / "journal.bin"):
                if rec["event"] == "server-uid":
                    boots += 1
                elif rec["event"] == "task-finished":
                    per = finishes.setdefault(rec["job"], {})
                    per[rec["task"]] = per.get(rec["task"], 0) + 1
                    if k == 1 and boots == 2 and first_after is None:
                        first_after = rec["time"]
        for job, per in finishes.items():
            twice = [t for t, n in per.items() if n != 1]
            if sorted(per) != list(range(1, n_tasks + 1)) or twice:
                fails.append(f"journals: job {job} has {len(per)} tasks "
                             f"finished, {len(twice)} more than once")
        lost = [w for r in reports for w in r["lost"]]
        errors = [e for r in reports for e in r["errors"]]
        reattached = [s for r in reports for s in r["reattaches"]]
        if lost or errors:
            fails.append(f"simulated workers: lost {lost[:5]}, "
                         f"errors {errors[:3]}")
        if len(reattached) != len(shard_configs[1]):
            fails.append(f"{len(reattached)} of shard 1's "
                         f"{len(shard_configs[1])} workers reattached")
        want = f"device-{device.type}"
        checker = GreedyCutScanModel(device=device.type, backend="device")
        by_process, memory, n_held = {}, {}, 0
        t0 = time.perf_counter()
        for tag, (_proc, record) in servers.items():
            recs = read_records(record)
            ticks = [r for r in recs if r["kind"] == "tick"]
            last = ticks[-1] if ticks else {}
            by_process[tag] = {"solves": len(ticks),
                               "launches": last.get("launches", 0),
                               "resident": last.get("resident_launches", 0)}
            memory[tag] = last.get("device_memory")
            if any(r["backend"] != want for r in ticks):
                fails.append(f"{tag}: solves on "
                             f"{sorted({str(r['backend']) for r in ticks})}")
            if device.type == "cuda" and (
                    last.get("launches") != len(ticks)
                    or last.get("resident_launches") != len(ticks)
                    or last.get("gang_launches")):
                fails.append(f"{tag}: K1 {by_process[tag]} for "
                             f"{len(ticks)} solves")
            for n, r in enumerate(ticks):
                try:
                    check_tick_against_plain(checker, r["kwargs"],
                                             r["counts"], device, n)
                except AssertionError as e:
                    fails.append(f"{tag} solve {n}: {e}")
                    break
                n_held += 1
            ends = [r for r in recs if r["kind"] == "end"]
            for r in ends:
                fails += [f"{tag}: {f}" for f in r["failures"]]
        if not by_process["standby"]["solves"]:
            fails.append("the promoted successor solved nothing")
        plain_check_s = time.perf_counter() - t0
        mark("checked")
        if fails:
            raise AssertionError("federation: " + "; ".join(fails))
        failover = {
            "kill_to_promotion_s": promote_s,
            "kill_to_access_s": promote_s + promoted_access_s,
            "kill_to_first_successor_finish_s":
                first_after - killed_at if first_after else None,
            "reattach_s_p50": _pctl(reattached, 50),
            "reattach_s_max": max(reattached),
            "reattach_attempts_timed_out": sum(
                r["attempts_timed_out"] for r in reports),
            "discarded": sum(r["discarded"] for r in reports),
            "drain_s": drain_s, "lease_timeout_s": FED_LEASE_S}
        log("federation_failover", migrate_s=migrate["s"], moved=moved,
            **failover, card=card)
        log("federation_stop", stop_s=stop_s, exits=exits,
            epochs=epochs, card=card)
        summary = dict(
            tasks_per_job=n_tasks, service_s=list(service_s),
            workers={k: len(c) + (k == 0) for k, c in shard_configs.items()},
            worker_processes=len(procs), access_s=out["access_s"],
            submit_s=out["submit_s"], reads_s=out["reads_s"],
            migrate_s=migrate["s"], failover=failover,
            launches_by_process=by_process, device_memory=memory,
            solves_held=n_held, plain_check_s=plain_check_s,
            finished={str(j): len(p) for j, p in finishes.items()},
            path_phases_s=marks, seconds=time.perf_counter() - t_path,
            budget_s=FED_BUDGET_S)
        log("federation_summary", **summary, card=card)
        return summary
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for proc in [p for p, _r in servers.values()] + (
                [worker] if worker is not None else []) + [
                r["proc"] for r in hq.runs if "proc" in r]:
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)
        shutil.rmtree(tmp, ignore_errors=True)


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
    # before any process is spawned (the builds, then the server_start
    # path's server and workers inherit it)
    nofile_soft, nofile = raise_nofile_limit()

    # seconds of each phase, logged at the end (phase_seconds)
    phase_s: dict = {}
    t_phase = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 3)
        t_phase[0] = now
        rss, peak = rss_mb()
        log("phase_lap", name=name, seconds=phase_s[name],
            total=round(sum(phase_s.values()), 3), rss_mb=rss,
            peak_rss_mb=peak)

    # phase 1: the card and the builds, all started together; the native
    # codec is already loaded (transport/codec builds it at first import)
    from hyperqueue_tpu_torch.transport import codec
    if codec.BACKEND != "native":
        raise AssertionError("the native codec did not build: "
                             f"codec.BACKEND is {codec.BACKEND!r}")
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log("card", card=card, kind=kind, torch=torch.__version__,
        cuda=torch.version.cuda, nofile_soft_was=nofile_soft,
        nofile_soft=nofile)
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
        codec=codec.BACKEND, card=card)
    lap("1_builds")

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
    lap("2_kernel_vs_plain")

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
    lap("2b_sharded_vs_plain")

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
    events_check(last_case, device, k1["ms"], card)
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
    lap("3_4_main_path")

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

    lap("5_6_fused_path")
    # phase 7: the sync probe (K5)
    max_err_p, k5 = k5_phase(device, card)
    lap("7_sync_probe")

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
    lap("8_server_path")

    # phase 9: the multichip path, the server's seam around MultichipModel
    # over N_SHARDS shards of the card
    m_model = MultichipModel(devices=[device] * N_SHARDS)
    multi, m_model, (m_kwargs, m_counts), m_tick = server_path(
        card, device, m_model, tag="multichip",
        n_sync=N_MULTICHIP_SYNC_TICKS,
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
    # the states of phases 3-10 (a north star of 1M tasks each) are not
    # read again: they go before the phases that start servers beside
    # this process (the server path froze them, as a server freezes its
    # start-up state)
    del (model, one_tick, last_case, f_case, f_one_tick, s_model, s_kwargs,
         s_counts, s_tick, m_model, m_kwargs, m_counts, m_tick, mesh, m_case)
    gc.unfreeze()
    gc.collect()
    torch.cuda.empty_cache()
    lap("9_10_multichip_path")

    # phase 11: min-utilization workers at the north star (K1 and the host
    # search); phase 12: `--scheduler milp` with its degraded tick
    mu = mu_path(card, device, set())
    lap("11_mu_path")
    milp = milp_path(card, device, set())
    lap("12_milp_path")

    # phases 13 and 14: the server's tick itself, reactor.schedule over the
    # north star held as lazy array chunks, then in fused mode
    react = reactor_path(card, device)
    lap("13_reactor_path")
    react_fused = reactor_fused_path(card, device)
    lap("14_reactor_fused_path")

    # phase 15: the journal, a journaled server's kill -9 and restore
    jour = journal_path(card, device)
    lap("15_journal_path")
    reactor_steady = react["medians"]["sync"]
    log("journal_vs_reactor",
        # the reactor path's workers answer through JobSink (no journal),
        # the journal path's through the EventBridge into the journal; the
        # journal path's ticks run without prefill
        reactor_wall_median_ms=reactor_steady["wall_median_ms"],
        reactor_prefill_median_ms=reactor_steady["phases_median_ms"]
        .get("prefill"),
        reactor_answer_median_ms=reactor_steady["answer_ms_median"],
        reactor_messages_median=reactor_steady["messages_median"],
        journal_wall_median_ms=jour["a_medians"]["wall_ms"],
        journal_answer_median_ms=jour["a_medians"]["answer_ms"],
        journal_records_median=jour["a_medians"]["journal_records"],
        journal_answer_us_per_record=jour["a_medians"]["answer_ms"] * 1e3
        / max(jour["a_medians"]["journal_records"], 1),
        card=card)
    # phase 16: `hq server start` over TCP: the server in a child process,
    # 1,024 workers and the client over the wire
    serve = server_start_path(card, device)
    lap("16_server_start_path")
    log("server_start_vs_reactor",
        # the reactor path drives reactor.schedule from this process with
        # the workers' answers between ticks; here the server's own loop
        # ticks while the workers' frames arrive
        reactor_wall_median_ms=reactor_steady["wall_median_ms"],
        reactor_tick0_ms=react["first_tick"]["wall_ms"],
        server_start_tick0_ms=serve["ticks"].get("tick0_ms"),
        server_start_steady_median_ms=serve["ticks"].get("steady_median_ms"),
        server_start_steady_p99_ms=serve["ticks"].get("steady_p99_ms"),
        card=card)
    # phase 17: one worker node, the deployment HyperQueue documents
    node = worker_node_path(card, device)
    lap("17_worker_node_path")
    # phase 18: the north star through the port's own `hq` command line
    cli = cli_path(card, device)
    lap("18_cli")
    # phase 19: the allocation service, its demand query on K1 beside the
    # tick, a kill -9 by fault plan mid-submit and the reconciling restore
    alloc, alloc_cases = alloc_path(card, device)
    alloc_k1 = {site: kernel_timing(alloc_cases[case], device, step_lat)
                for site, case in (("tick", "tick"),
                                   ("alloc_query", "query"))}
    for site, timing in alloc_k1.items():
        log("timing", kernel="cut_scan", site=site, path="autoalloc",
            **timing, card=card)
    lap("19_autoalloc")
    # phase 20: the deterministic simulator, the real server on a virtual
    # clock with kill -9 and restore, K1 at every tick; then K1 at the
    # soak's widest recorded solve
    sim_summary, sim_case, _sim_soak = sim_path(card, device)
    sim_k1 = kernel_timing(sim_case, device, step_lat)
    log("timing", kernel="cut_scan", site="tick", path="sim", **sim_k1,
        card=card)
    lap("20_sim")
    # phase 21: two shards and a standby over one root, a migration, a
    # kill -9 of a shard and its promoted successor
    fed = federation_path(card, device)
    lap("21_federation")
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
            # server A's ticks and the restored server B's
            "journal_launches": jour["launches"]["cut_scan"]
            if name == "cut_scan" else 0,
            # the server child's scheduler loop (phases 16 and 17)
            "server_start_launches": serve["launches"]
            if name == "cut_scan" else 0,
            "worker_node_launches": node["launches"]
            if name == "cut_scan" else 0,
            # both `hq server start` processes of phase 18
            "cli_launches": cli["launches"] if name == "cut_scan" else 0,
            # both servers of phase 19, by launch site, and the kernel's
            # time at each site's shape there
            "autoalloc_launches_by_site": alloc["launches_by_site"]
            if name == "cut_scan" else {"tick": 0, "alloc_query": 0},
            "autoalloc_ms_by_site": {
                site: {k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "shape")}
                for site, timing in alloc_k1.items()}
            if name == "cut_scan" else None,
            # phase 20's simulations under `greedy` (every tick's solve, in
            # every incarnation), and K1's time at the soak's widest solve
            "sim_launches": sim_summary["launches_total"]
            if name == "cut_scan" else 0,
            "sim_launches_by_run": sim_summary["launches"]
            if name == "cut_scan" else {},
            "sim_ms": {k: sim_k1[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "shape")}
            if name == "cut_scan" else None,
            # phase 21: each shard process's and the standby's (its
            # promoted successor's) launches and solves
            "federation_launches_by_process": fed["launches_by_process"]
            if name == "cut_scan" else {},
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
    log("phase_seconds", **phase_s,
        total=round(sum(phase_s.values()), 3), card=card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# the idle probes after phase 18 in profiler_bisect: how many, seconds apart
BISECT_IDLE_PROBES = 4
BISECT_IDLE_S = 60.0


def profiler_bisect(out_dir=".") -> int:
    """`python3 chip_smoke.py --profiler-bisect [DIR]`: phase 4's profiler
    window
    (profiler_probe, at phase 2's bench instance) alone at the start, then
    BISECT_IDLE_PROBES times BISECT_IDLE_S apart with the process idle,
    then after each of phases 16, 17 and 18: which phase, or how much of
    the process's time, leaves the profiler without device events. Writes
    the windows to DIR/profiler_bisect.json (DIR: the working directory
    unless given) as they come and prints them as JSON last."""
    import torch

    from hyperqueue_tpu_torch.ops.build import load_library
    from hyperqueue_tpu_torch.utils.native import load_native

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device = torch.device("cuda")
    install_native_takes()
    raise_nofile_limit()
    card = card_info()
    with ThreadPoolExecutor(max_workers=4) as pool:
        builds = [pool.submit(load_library, name)
                  for name in ("cut_scan", "sync_probe", "sharded_scan")]
        native = pool.submit(load_native)
        for f in builds:
            f.result()
        if native.result() is None:
            raise AssertionError("the native host scan did not build")
    global THREADS
    THREADS = int(load_library("cut_scan")[0].hq_cut_scan_block_threads())
    case = bench_instance()
    os.makedirs(out_dir, exist_ok=True)
    windows = []

    def probe(tag):
        windows.extend(profiler_probe(case, device, tag, card))
        with open(os.path.join(out_dir, "profiler_bisect.json"), "w") as f:
            json.dump(windows, f, indent=1)

    probe("start")
    # the process idle first: what time alone does to the windows
    for i in range(BISECT_IDLE_PROBES):
        time.sleep(BISECT_IDLE_S)
        probe(f"idle_{i + 1}")
    for tag, phase in (("after_16", server_start_path),
                       ("after_17", worker_node_path),
                       ("after_18", cli_path)):
        phase(card, device)
        probe(tag)
    print(json.dumps({"profiler_bisect": windows}))
    return 0


if __name__ == "__main__":
    sys.exit(profiler_bisect(*sys.argv[2:3])
             if sys.argv[1:2] == ["--profiler-bisect"] else main())
