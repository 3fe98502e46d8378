"""The device sync-latency probe (K5) of the solve backend's cost model.

`models/greedy.device_sync_ms` asks how long the smallest useful device
program takes from launch to a value in host memory; a tick whose device
round trip alone would blow its latency budget solves on the host instead.
The program is `(v * 2).sum()` over `arange(256, int32)`, the JAX package's
probe: on CUDA tensors `sync_probe` launches the hand-written kernel
`csrc/sync_probe.cu` (one block of 256 threads, warp-shuffle reduction),
on CPU tensors it runs `sync_probe_reference`, its plain PyTorch version.
Either way the int32 sum wraps modulo 2^32, as JAX's does.

`sync_round_trip_ms` times the round trip on a stream of its own, so that
it never waits behind a solve in flight on the tick's stream.
"""

from __future__ import annotations

import ctypes
import time

import torch

PROBE_SIZE = 256
# sum of 2 * arange(256): the probe's own check of its answer
_PROBE_SUM = PROBE_SIZE * (PROBE_SIZE - 1)


def sync_probe_reference(v: torch.Tensor) -> torch.Tensor:
    """The probe in plain PyTorch: () int32 sum of v * 2, wrapping."""
    return (v * 2).sum(dtype=torch.int32)


def _probe_lib():
    from hyperqueue_tpu_torch.ops.build import load_library

    lib, record = load_library("sync_probe")
    if not getattr(lib, "_hq_prototypes", False):
        vp = ctypes.c_void_p
        lib.hq_sync_probe.argtypes = [vp, vp, ctypes.c_int, vp]
        lib.hq_sync_probe.restype = ctypes.c_int
        lib.hq_empty_kernel.argtypes = [vp]
        lib.hq_empty_kernel.restype = ctypes.c_int
        lib._hq_prototypes = True
    return lib, record


def sync_probe(v: torch.Tensor) -> torch.Tensor:
    """() int32 sum of v * 2 (wrapping modulo 2^32) for a 1-D contiguous
    int32 tensor.

    On a CUDA tensor it launches the kernel on the current stream, does
    not synchronize, and counts the launch in `sync_probe.launches`; a
    refused launch raises. On a CPU tensor it runs sync_probe_reference.
    """
    if v.dtype != torch.int32:
        raise TypeError(f"v must be int32, got {v.dtype}")
    if v.dim() != 1 or not v.is_contiguous():
        raise ValueError("v must be a contiguous 1-D tensor")
    if v.device.type == "cpu":
        return sync_probe_reference(v)
    if v.device.type != "cuda":
        raise ValueError(f"sync_probe runs on cuda or cpu, not {v.device}")
    if v.numel() >= 2**31:
        raise ValueError("v has more elements than an int can count")
    lib, _record = _probe_lib()
    out = torch.empty((), dtype=torch.int32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.hq_sync_probe(v.data_ptr(), out.data_ptr(), v.numel(),
                               stream)
    if rc != 0:
        raise RuntimeError(f"sync-probe kernel launch failed: cudaError {rc}")
    sync_probe.launches += 1
    return out


sync_probe.launches = 0


def empty_launch(device="cuda") -> None:
    """Launch a kernel of the probe's shape that does nothing, on the
    current stream, without synchronizing or counting: its device time is
    the card's floor for a launch, the probe's latency bound."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel needs a CUDA device, not {device}")
    lib, _record = _probe_lib()
    with torch.cuda.device(device):
        rc = lib.hq_empty_kernel(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")


def sync_round_trip_ms(device="cuda", reps: int = 3) -> float:
    """The device's sync round trip in ms: launch the probe kernel, copy
    its 4-byte answer into pinned host memory and wait for an event behind
    the copy; the minimum of `reps` round trips after one warm-up, on a
    stream of the probe's own. Raises if the device is not CUDA, a launch
    fails or the answer is wrong."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the sync probe needs a CUDA device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("the sync probe needs a CUDA device and none is "
                           "available")
    times = []
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            v = torch.arange(PROBE_SIZE, dtype=torch.int32, device=device)
            host = torch.empty((), dtype=torch.int32, pin_memory=True)
            done = torch.cuda.Event()
            for rep in range(reps + 1):  # the first round trip warms up
                t0 = time.perf_counter()
                host.copy_(sync_probe(v), non_blocking=True)
                done.record(stream)
                done.synchronize()
                if rep:
                    times.append((time.perf_counter() - t0) * 1e3)
                if int(host) != _PROBE_SUM:
                    raise AssertionError(
                        f"sync probe answered {int(host)}, not {_PROBE_SUM}"
                    )
    return min(times)
