"""Python user API.

Reference: crates/pyhq/python/hyperqueue — Client, Job (program + Python
function tasks with dependencies), LocalCluster.
"""

from hyperqueue_tpu_torch.api.client import (
    Client,
    FailedJobsException,
    Job,
    LocalCluster,
    Task,
)

__all__ = ["Client", "FailedJobsException", "Job", "LocalCluster", "Task"]
