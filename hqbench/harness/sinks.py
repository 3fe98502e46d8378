"""The benchmark's own Comm and EventSink for `reactor.schedule`.

The Comm keeps what a tick sends (compute messages and retracts) for the
worker model to answer. The EventSink forwards task news to the port's
`JobManager`, as the server's EventBridge does (without its journal and
trace spans), rewritten from chip_smoke's `ReactorComm` and `JobSink`.
No task may fail or be canceled and no worker may be lost in a cell.
"""

from __future__ import annotations


class Comm:
    def __init__(self):
        self.compute = []   # this tick's [(worker_id, [message])]
        self.retracts = []  # this tick's [(worker_id, [(task_id, inst)])]
        self.cancels = []
        self.asked = False  # a scheduling pass was asked for

    def send_compute(self, worker_id, tasks):
        self.compute.append((worker_id, tasks))

    def send_cancel(self, worker_id, task_ids):
        self.cancels.append((worker_id, list(task_ids)))

    def send_retract(self, worker_id, task_refs):
        self.retracts.append((worker_id, list(task_refs)))

    def ask_for_scheduling(self):
        self.asked = True

    def take(self):
        """This tick's (compute, retracts); clears both."""
        out = (self.compute, self.retracts)
        self.compute, self.retracts = [], []
        return out


class JobSink:
    def __init__(self, jobs, job_of):
        self.jobs = jobs
        self.job_of = job_of

    def on_task_started(self, task_id, instance_id, worker_ids, variant=0,
                        wtrace=None):
        self.jobs.on_task_started(self.job_of(task_id), task_id, worker_ids)

    def on_task_restarted(self, task_id):
        self.jobs.on_task_restarted(self.job_of(task_id), task_id)

    def on_task_finished(self, task_id, wtrace=None):
        self.jobs.on_task_finished(self.job_of(task_id), task_id)

    def on_task_failed(self, task_id, message, wtrace=None):
        raise RuntimeError(f"task {task_id} failed: {message}")

    def on_task_canceled(self, task_id):
        raise RuntimeError(f"task {task_id} canceled")

    def on_worker_new(self, worker):
        pass

    def on_worker_lost(self, worker_id, reason):
        raise RuntimeError(f"worker {worker_id} lost: {reason}")
