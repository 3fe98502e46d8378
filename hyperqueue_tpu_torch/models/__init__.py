"""Scheduler models: a model consumes a dense tick snapshot and produces
per-(batch, variant, worker) task counts. `greedy` is the cut-scan model
(the CUDA kernel on the card), `multichip` shards its worker axis
(`--scheduler multichip`), and `milp` is the exact host MILP (scipy HiGHS),
the accuracy oracle and `--scheduler milp`."""

from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.models.milp import MilpModel
from hyperqueue_tpu_torch.models.multichip import MultichipModel

__all__ = ["GreedyCutScanModel", "MilpModel", "MultichipModel"]
