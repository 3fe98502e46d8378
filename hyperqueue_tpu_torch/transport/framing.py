"""Length-delimited frames with msgpack payloads, and the wire's
trace-context header.

Reference: crates/tako/src/internal/transfer/transport.rs:4-8 — little-endian
length-prefixed frames, max 128 MiB (lib.rs:31), bincode payloads. We use
msgpack (self-describing, language-neutral) over a u32-LE length prefix.
The payload codec is the port's `transport/codec.py`: the same bytes as
``msgpack.packb(obj, use_bin_type=True)``, and it accepts what
``msgpack.unpackb(raw=False, strict_map_key=False)`` accepts, so a frame
of this package and one of the JAX package are interchangeable. This
module imports nothing beyond the standard library and the codec, so the
reactor runs where msgpack is not installed.
"""

from __future__ import annotations

import asyncio
import struct

from hyperqueue_tpu_torch.transport import codec

MAX_FRAME_SIZE = 128 * 1024 * 1024
_LEN = struct.Struct("<I")


class FrameError(Exception):
    pass


def pack_payload(obj) -> bytes:
    return codec.packb(obj)


def unpack_payload(data):
    # accepts bytes OR a memoryview (the decrypted-in-place zero-copy
    # path hands views through here)
    return codec.unpackb(data, strict_map_key=False)


async def write_frame(writer: asyncio.StreamWriter, data: bytes) -> None:
    if len(data) > MAX_FRAME_SIZE:
        raise FrameError(f"frame too large: {len(data)}")
    # two buffered writes instead of one header+body concatenation: the
    # transport coalesces them, and a large sealed frame is not copied a
    # second time just to prepend 4 bytes
    writer.write(_LEN.pack(len(data)))
    writer.write(data)
    await writer.drain()


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_SIZE:
        raise FrameError(f"frame too large: {length}")
    return await reader.readexactly(length)


# ---------------------------------------------------------------------
# Trace-context header: control-plane messages carry the trace id and the
# sender's span id under one well-known key, so every hop of a task's
# causal trace names its parent.  Kept at the framing layer because it is
# part of the wire contract (client submit, compute downlink, and
# task-state uplinks all stamp it), not any one plane's schema.
# ---------------------------------------------------------------------

TRACE_KEY = "trace"


def attach_trace(msg: dict, trace_id: str, parent: str | None = None,
                 **stamps) -> dict:
    """Stamp a trace-context header onto a message payload (in place)."""
    ctx: dict = {"id": trace_id}
    if parent is not None:
        ctx["parent"] = parent
    ctx.update(stamps)
    msg[TRACE_KEY] = ctx
    return msg


def attach_trace_wire(msg: dict, trace_id: str,
                      parent: str | None) -> dict:
    """Compact per-task form for high-volume planes (compute downlink):
    a two-element array instead of a keyed dict. On deployments stuck on
    the pure-python ChaCha fallback every wire byte is ~6 us of
    encryption, and this header rides EVERY dispatched task."""
    msg[TRACE_KEY] = [trace_id, parent]
    return msg


def read_trace(msg: dict) -> dict | None:
    """The message's trace-context header (either form) as a dict, or
    None when absent/malformed."""
    ctx = msg.get(TRACE_KEY)
    if isinstance(ctx, dict):
        return ctx
    if isinstance(ctx, (list, tuple)) and ctx:
        return {"id": ctx[0], "parent": ctx[1] if len(ctx) > 1 else None}
    return None
