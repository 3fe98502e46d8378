"""The wire's trace-context header.

Control-plane messages carry the trace id and the sender's span id under
one well-known key, so every hop of a task's causal trace names its parent.
It is part of the wire contract (client submit, compute downlink and
task-state uplinks all stamp it), not any one plane's schema, so it lives at
the framing layer.

Only these helpers are ported: the length-delimited frames and their
payload codec (msgpack in the JAX package) come with the server's network
plane. The reactor stamps the header onto each compute message through
attach_trace_wire, and this module imports nothing beyond the standard
library, so the reactor runs where msgpack is not installed.
"""

from __future__ import annotations

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
