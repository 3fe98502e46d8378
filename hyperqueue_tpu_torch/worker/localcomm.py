"""Node-local plane: `hq task notify` from inside a running task.

Reference: crates/tako/src/internal/worker/{localcomm,notifications}.rs — the
worker listens on a Unix socket; each task gets a random token in its env
(HQ_LOCAL_SOCKET / HQ_TOKEN); a notify message authenticated by the token is
forwarded to the server, which emits a task-notify event to listening
clients.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import secrets
from pathlib import Path

logger = logging.getLogger("hq.worker.localcomm")


class LocalCommListener:
    def __init__(self, runtime, work_dir: Path):
        self.runtime = runtime
        self.socket_path = str(
            Path(work_dir) / f"hq-local-{os.getpid()}.sock"
        )
        self.tokens: dict[str, int] = {}  # token -> packed task id
        self._server: asyncio.base_events.Server | None = None

    def register_task(self, task_id: int) -> str:
        token = secrets.token_hex(16)
        self.tokens[token] = task_id
        return token

    def unregister_task(self, task_id: int) -> None:
        self.tokens = {t: tid for t, tid in self.tokens.items() if tid != task_id}

    async def start(self) -> None:
        self._server = await asyncio.start_unix_server(
            self._handle, path=self.socket_path
        )

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    async def _handle(self, reader, writer) -> None:
        try:
            data = await asyncio.wait_for(reader.readline(), timeout=5)
            msg = json.loads(data)
            token = msg.get("token", "")
            task_id = self.tokens.get(token)
            if task_id is None:
                writer.write(b'{"error": "invalid token"}\n')
            else:
                await self.runtime._send(
                    {
                        "op": "task_notify",
                        "id": task_id,
                        "payload": str(msg.get("payload", ""))[:4096],
                    }
                )
                writer.write(b'{"ok": true}\n')
            await writer.drain()
        except (asyncio.TimeoutError, json.JSONDecodeError, OSError) as e:
            logger.debug("local notify failed: %s", e)
        finally:
            writer.close()


def notify_from_task(payload: str) -> None:
    """Called by `hq task notify` INSIDE a task (sync, uses task env)."""
    import socket

    sock_path = os.environ.get("HQ_LOCAL_SOCKET")
    token = os.environ.get("HQ_TOKEN")
    if not sock_path or not token:
        raise RuntimeError(
            "not inside a hyperqueue task (HQ_LOCAL_SOCKET/HQ_TOKEN missing)"
        )
    with socket.socket(socket.AF_UNIX) as s:
        s.settimeout(5)
        s.connect(sock_path)
        s.sendall(
            (json.dumps({"token": token, "payload": payload}) + "\n").encode()
        )
        response = s.recv(4096)
    if b'"ok"' not in response:
        raise RuntimeError(f"notify rejected: {response.decode(errors='replace')}")
