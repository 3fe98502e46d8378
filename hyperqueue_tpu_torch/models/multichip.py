"""Multi-shard scheduling model: the sharded cut-scan (K2) as a production
backend.

Selected with `--scheduler=multichip`. Same `solve` interface and identical
semantics as GreedyCutScanModel (the sharded kernel reproduces the
single-block visit order exactly, see parallel/solve.py); the worker axis is
split over a mesh of shards so that a step's work per shard scales with
W / D.

Shards: the mesh is built lazily, at the first solve, from `devices` when
the caller passes them (a device may repeat: repeats are shards of one
card, D blocks of one launch of the sharded kernel), else from the visible
cards of the model's device type, the first `n_devices` of them when given.
With a single shard the model is exactly GreedyCutScanModel (K1). A mesh
over several cards raises NotImplementedError: the exchange across cards is
not ported yet (ROADMAP, Queue 1 item 1).

With a mesh, the adaptive host-vs-device cost model is bypassed: selecting
multichip means "shard my solve", so every solve runs the sharded kernel
(backend_reason "multichip-mesh"), the resident one and the paranoid
check's fresh full upload alike. On one card the shards are row ranges of
the one resident (W, R) state, so the residency (dirty-row uploads, the
in-place solve) is the parent's, unchanged.

The model runs on the card unless the caller asks for the CPU; without CUDA
a card model raises, as GreedyCutScanModel does.
"""

from __future__ import annotations

import logging

import torch

from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.parallel.solve import (
    make_worker_mesh,
    sharded_cut_scan,
)

logger = logging.getLogger(__name__)


class MultichipModel(GreedyCutScanModel):
    def __init__(self, n_devices: int | None = None, device="cuda",
                 devices=None, **kwargs):
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ValueError("devices must name at least one shard")
            device = devices[0]
        super().__init__(device=device, **kwargs)
        if self.device.type == "cuda":
            # built now, not inside the first solve under the watchdog's
            # deadline
            from hyperqueue_tpu_torch.parallel.solve import _sharded_scan_lib

            _sharded_scan_lib()
        self._requested_devices = n_devices
        self._devices = devices
        self._mesh = None  # built at the first solve; False = one shard

    def _get_mesh(self):
        if self._mesh is None:
            devices = self._devices
            if devices is None:
                if self.device.type == "cuda":
                    devices = [torch.device("cuda", i)
                               for i in range(torch.cuda.device_count())]
                else:
                    devices = [self.device]
            if self._requested_devices:
                devices = devices[:self._requested_devices]
            if len(devices) <= 1:
                self._mesh = False
                logger.info("multichip scheduler: one shard, using the "
                            "single-block kernel")
            else:
                self._mesh = make_worker_mesh(devices)
                logger.info("multichip scheduler: worker axis sharded %d "
                            "ways on %s", len(self._mesh), self._mesh[0])
        return self._mesh

    def _worker_bucket(self, n_w: int) -> int:
        pw = super()._worker_bucket(n_w)
        mesh = self._get_mesh()
        if mesh:
            d = len(mesh)
            pw = -(-pw // d) * d  # the shards split W evenly
        return pw

    def _backend_decision(self, shape_key):
        if self._get_mesh():
            return "device", "multichip-mesh"
        return super()._backend_decision(shape_key)

    def _kernel_dispatch(self, free_d, nt_d, life_d, total_d, inputs,
                         site="tick"):
        mesh = self._get_mesh()
        if not mesh:
            return super()._kernel_dispatch(free_d, nt_d, life_d, total_d,
                                            inputs, site=site)
        return sharded_cut_scan(mesh, free_d, nt_d, life_d, total=total_d,
                                **inputs)
