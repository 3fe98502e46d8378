"""Scheduler models: a model consumes a dense tick snapshot and produces
per-(batch, variant, worker) task counts."""

from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.models.multichip import MultichipModel

__all__ = ["GreedyCutScanModel", "MultichipModel"]
