"""Automatic allocation: elastic workers via PBS/Slurm.

Reference: crates/hyperqueue/src/server/autoalloc/ — allocation queues with
backlog, workers-per-alloc and limits; a periodic process refreshes allocation
statuses via qstat/sacct, plans submissions against the scheduler's
fake-worker query, submits qsub/sbatch scripts that start workers, and backs
off (eventually pausing the queue) on repeated failures.
"""
