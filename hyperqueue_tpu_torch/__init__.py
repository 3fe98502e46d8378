"""hyperqueue_tpu_torch — the HyperQueue scheduler ported to PyTorch + CUDA.

The per-tick scheduling solve runs as a hand-written CUDA kernel on an
NVIDIA Hopper GPU (csrc/cut_scan.cu); everything around it is host code.
This package stands alone: it imports torch and numpy, never jax.

Layout (mirrors the JAX package's):
  ids, resources/   — data model (IDs, fixed-point amounts, requests, maps)
  scheduler/        — queues -> batches -> dense inputs -> solve -> mapping
  ops/              — the cut-scan: host visit classes, CUDA kernel, plain
                      PyTorch version, kernel build
  parallel/         — device-resident solver state, the sharded solve
  models/           — the greedy cut-scan model (padding, residency) and
                      its sharded form (multichip)
  convert           — tick state from plain data
  server/           — the server: data model, reactor, journal, planes
  transport/        — frames, the msgpack codec, auth and the wire AEAD
  csrc/             — CUDA C++ sources, built at first use into _build/
"""

# the handshake and `hq server info` send these; a JAX worker or client
# checks them against its own (the same values as the JAX package's)
__version__ = "0.3.0"

PROTOCOL_VERSION = 2  # v2: shared compute-message bodies + never-restart=-1
