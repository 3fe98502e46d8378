"""A stopping port server still answers the `stop_server` that stopped it.

The client plane's thread (`server/ingest.IngestPlane`) writes each reply
from a sender task of its own. `Server.shutdown()` stops the plane a few
tens of milliseconds after the `stop_server` answer was queued; on a busy
host the sender had not written it yet, the plane closed the connection,
and `hq server stop` retried against a server that was gone and exited 1.
The plane now lets each sender write what was queued before it closes
the connections (within `STOP_FLUSH_SECS`). Here the sender waits before
every write, longer than the shutdown takes to reach the plane, and the
client must still read its answer.
"""

from __future__ import annotations

import asyncio

import torch

from hyperqueue_tpu_torch.server import bootstrap
from hyperqueue_tpu_torch.server import ingest
from hyperqueue_tpu_torch.transport import auth

torch.set_num_threads(1)

# how long the plane's sender waits before each write: past the shutdown's
# own pauses, inside the plane's flush bound
SEND_DELAY_S = 0.5
WAIT_S = 20.0


def test_stop_server_answer_survives_a_slow_sender(tmp_path, monkeypatch):
    assert SEND_DELAY_S < ingest.STOP_FLUSH_SECS
    sender = ingest.IngestPlane._sender

    async def slow_sender(self, channel):
        conn = channel.conn
        send = conn.send

        async def late_send(frame):
            await asyncio.sleep(SEND_DELAY_S)
            await send(frame)

        conn.send = late_send
        await sender(self, channel)

    monkeypatch.setattr(ingest.IngestPlane, "_sender", slow_sender)

    async def scenario():
        server = bootstrap.Server(
            device="cpu", server_dir=tmp_path / "server",
            client_plane="thread", fanout_senders=0)
        access = await server.start()
        assert server.ingest_plane is not None
        # as `hq server start` runs it: the shutdown follows the stop
        stopped = asyncio.ensure_future(server.run_until_stopped())
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", access.client_port)
        conn = await auth.do_authentication(
            reader, writer, auth.ROLE_CLIENT, auth.ROLE_SERVER,
            access.client_key_bytes())
        try:
            await conn.send({"op": "server_info"})
            info = await asyncio.wait_for(conn.recv(), WAIT_S)
            await conn.send({"op": "stop_server"})
            answer = await asyncio.wait_for(conn.recv(), WAIT_S)
            await asyncio.wait_for(stopped, WAIT_S)
        finally:
            conn.close()
            await conn.wait_closed()
        return info, answer

    info, answer = asyncio.run(asyncio.wait_for(scenario(), 3 * WAIT_S))
    assert info.get("op") != "error"
    assert answer == {"op": "ok"}
