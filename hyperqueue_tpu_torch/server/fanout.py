"""Fan-out plane: downlink framing + AEAD seal on a sender thread pool.

The reactor's other single-core tax (after the journal, see
server/journal_plane.py) was outbound framing: every worker downlink
batch and every client response/stream frame was msgpack-encoded and
ChaCha20-Poly1305-sealed INLINE on the loop that owns the socket — the
`fanout` lag plane of the stall detector. With encryption on, the
seal dominates (per wire byte), and with 1k workers a tick's compute
fan-out serialized the whole cluster's crypto onto one core.

This pool moves the CPU half of a send — `Connection.encode` (msgpack +
seal) — onto dedicated sender threads; the cheap half (two buffered
writes + drain) stays on the loop that owns the transport. Ordering is
preserved per connection because each connection has exactly ONE sender
coroutine, which awaits the offloaded encode before writing: counter
nonces are consumed in send order, frames hit the socket in seal order.
Different connections' encodes run concurrently across the pool — with
N senders and native/numpy AEAD, downlink crypto scales to N cores
instead of pinning one.

The existing bounded-queue/drop semantics are untouched: per-worker
queues, per-client outqueues and subscriber buffers backpressure (or
drop) exactly as before — this plane only changes WHERE the encode runs.

`--fanout-senders 0` keeps encodes inline on the owning loop (escape
hatch, mirroring `--client-plane reactor` / `--journal-plane reactor`).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

from hyperqueue_tpu_torch.utils.metrics import REGISTRY

FANOUT_FRAMES = REGISTRY.counter(
    "hq_fanout_plane_frames_total",
    "downlink frames encoded+sealed by the sender pool",
)
FANOUT_BYTES = REGISTRY.counter(
    "hq_fanout_plane_bytes_total",
    "wire bytes produced by the sender pool",
)
FANOUT_BATCH = REGISTRY.histogram(
    "hq_fanout_plane_batch_msgs",
    "messages coalesced per downlink frame by the worker sender",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
FANOUT_STALLS = REGISTRY.counter(
    "hq_fanout_plane_send_stalls_total",
    "sends whose encode+write exceeded the 50 ms stall threshold "
    "(slow consumer socket or an oversubscribed sender pool)",
)

SEND_STALL_SECONDS = 0.05

# note_send runs on BOTH the reactor loop (worker senders) and the
# ingest-plane loop (client senders); the registry's `value +=` is a
# non-atomic read-modify-write, so these shared counters take a lock —
# unlike every other metric in the tree, which has a single writer
_NOTE_LOCK = threading.Lock()


class SendPool:
    """Shared encode executor for every outbound plane of one server."""

    def __init__(self, senders: int):
        self.senders = max(int(senders), 0)
        self.executor = (
            ThreadPoolExecutor(
                max_workers=self.senders, thread_name_prefix="hq-fanout"
            )
            if self.senders
            else None
        )

    @property
    def enabled(self) -> bool:
        return self.executor is not None

    async def encode(self, loop, conn, payload) -> bytes:
        """Encode+seal `payload` for `conn`, on the pool when enabled.
        Must be awaited from the connection's single sender task (seal
        order = send order)."""
        if self.executor is None:
            return conn.encode(payload)
        return await loop.run_in_executor(
            self.executor, conn.encode, payload
        )

    @staticmethod
    def note_send(n_msgs: int, n_bytes: int, dt: float) -> None:
        with _NOTE_LOCK:
            FANOUT_FRAMES.inc()
            FANOUT_BYTES.inc(n_bytes)
            FANOUT_BATCH.observe(n_msgs)
            if dt >= SEND_STALL_SECONDS:
                FANOUT_STALLS.inc()

    def stop(self) -> None:
        if self.executor is not None:
            self.executor.shutdown(wait=False, cancel_futures=True)
