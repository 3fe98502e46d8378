"""Mutual authentication + stream encryption.

Reference: crates/tako/src/internal/transfer/auth.rs:28-226 — challenge-
response HMAC bound to role strings ("hq-server"/"hq-worker"/"hq-client"),
then authenticated stream encryption negotiated per connection, with separate
pre-shared keys for the client plane and the worker plane
(reference common/serverdir.rs:157-188).

Handshake (both directions symmetric):
  1. hello frame (plaintext msgpack): {role, nonce(32B), version, encrypt}
  2. challenge response: HMAC-SHA256(key, peer_nonce || own_role)
  3. on success, directional ChaCha20-Poly1305 keys derived via HKDF over
     both nonces; every subsequent frame body is sealed with a counter nonce.

With key=None both sides must agree encryption is off; frames stay plaintext.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import os
import struct

# backend ladder (transport/aead.py): cryptography's native AEAD, the
# system libcrypto via ctypes, the numpy-vectorized implementation, then
# the pure-python reference — bit-identical wire format across all four,
# forcible via HQ_WIRE_BACKEND
from hyperqueue_tpu_torch.transport.aead import ChaCha20Poly1305

from hyperqueue_tpu_torch import PROTOCOL_VERSION
from hyperqueue_tpu_torch.transport.framing import (
    pack_payload,
    read_frame,
    unpack_payload,
    write_frame,
)

ROLE_SERVER = "hq-server"
ROLE_WORKER = "hq-worker"
ROLE_CLIENT = "hq-client"

_NONCE_CTR = struct.Struct("<Q")


class AuthError(Exception):
    pass


class StreamSeal:
    """Directional ChaCha20-Poly1305 sealing with a monotonically increasing
    counter nonce — replay and reorder within a connection are rejected by
    construction."""

    __slots__ = ("_aead", "_counter", "_prefix")

    def __init__(self, key: bytes, prefix: bytes):
        self._aead = ChaCha20Poly1305(key)
        self._counter = 0
        self._prefix = prefix  # 4 bytes, distinguishes direction

    def _next_nonce(self) -> bytes:
        nonce = self._prefix + _NONCE_CTR.pack(self._counter)
        self._counter += 1
        return nonce

    def seal(self, data) -> bytes:
        return self._aead.encrypt(self._next_nonce(), data, None)

    def open(self, data) -> bytes:
        # memoryview in, so the backend slices ct/tag without copying
        return self._aead.decrypt(self._next_nonce(), memoryview(data), None)


class Connection:
    """A framed, optionally encrypted, msgpack message stream."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        sealer: StreamSeal | None = None,
        opener: StreamSeal | None = None,
    ):
        self.reader = reader
        self.writer = writer
        self._sealer = sealer
        self._opener = opener

    def encode(self, obj) -> bytes:
        """msgpack-encode + seal one frame body WITHOUT writing it —
        the CPU-heavy half of send(), safe to run on a sender-pool
        thread (server/fanout.py) as long as each connection's frames
        are encoded in send order: the seal consumes one counter nonce
        per call, and the peer opens frames in arrival order."""
        data = pack_payload(obj)
        if self._sealer is not None:
            data = self._sealer.seal(data)
        return data

    async def send_bytes(self, data: bytes) -> None:
        """Write one pre-encoded frame body (see encode())."""
        await write_frame(self.writer, data)

    async def send(self, obj) -> None:
        await write_frame(self.writer, self.encode(obj))

    async def recv(self):
        data = await read_frame(self.reader)
        if self._opener is not None:
            data = self._opener.open(data)
        return unpack_payload(data)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

    async def wait_closed(self) -> None:
        try:
            await self.writer.wait_closed()
        except Exception:
            pass


def _hkdf(key: bytes, salt: bytes, info: bytes) -> bytes:
    prk = hmac.new(salt, key, hashlib.sha256).digest()
    return hmac.new(prk, info + b"\x01", hashlib.sha256).digest()


async def do_authentication(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    my_role: str,
    peer_role: str,
    secret_key: bytes | None,
) -> Connection:
    """Run the symmetric handshake; returns a ready Connection.

    Raises AuthError on role mismatch, bad challenge response, or
    encryption-expectation mismatch (reference auth.rs attack tests
    auth.rs:388-417 cover exactly these cases).
    """
    my_nonce = os.urandom(32)
    encrypt = secret_key is not None
    await write_frame(
        writer,
        pack_payload(
            {
                "role": my_role,
                "nonce": my_nonce,
                "version": PROTOCOL_VERSION,
                "encrypt": encrypt,
            }
        ),
    )
    hello = unpack_payload(await read_frame(reader))
    if hello.get("version") != PROTOCOL_VERSION:
        raise AuthError(f"protocol version mismatch: {hello.get('version')}")
    if hello.get("role") != peer_role:
        raise AuthError(
            f"unexpected peer role {hello.get('role')!r}, wanted {peer_role!r}"
        )
    if bool(hello.get("encrypt")) != encrypt:
        raise AuthError("encryption expectation mismatch")
    peer_nonce = hello["nonce"]
    if not isinstance(peer_nonce, bytes) or len(peer_nonce) != 32:
        raise AuthError("malformed nonce")

    if not encrypt:
        return Connection(reader, writer)

    assert secret_key is not None
    response = hmac.new(
        secret_key, peer_nonce + my_role.encode(), hashlib.sha256
    ).digest()
    await write_frame(writer, pack_payload({"hmac": response}))
    peer_response = unpack_payload(await read_frame(reader))
    expected = hmac.new(
        secret_key, my_nonce + peer_role.encode(), hashlib.sha256
    ).digest()
    if not hmac.compare_digest(peer_response.get("hmac", b""), expected):
        raise AuthError("challenge-response verification failed")

    # directional keys: lexicographic nonce order fixes the direction labels
    salt = min(my_nonce, peer_nonce) + max(my_nonce, peer_nonce)
    key_a = _hkdf(secret_key, salt, b"dir-a")
    key_b = _hkdf(secret_key, salt, b"dir-b")
    if my_nonce < peer_nonce:
        send_key, recv_key = key_a, key_b
        send_prefix, recv_prefix = b"dirA", b"dirB"
    else:
        send_key, recv_key = key_b, key_a
        send_prefix, recv_prefix = b"dirB", b"dirA"
    return Connection(
        reader,
        writer,
        sealer=StreamSeal(send_key, send_prefix),
        opener=StreamSeal(recv_key, recv_prefix),
    )
