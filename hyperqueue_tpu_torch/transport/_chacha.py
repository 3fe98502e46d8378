"""Pure-Python ChaCha20-Poly1305 AEAD (RFC 8439) fallback.

The container this framework runs in does not always ship the
`cryptography` wheel; transport/auth.py gates its import and falls back
to this implementation so servers, workers and clients keep their
authenticated-encryption wire format instead of crashing at import.

Scope: correctness over speed — frames on the control planes are small
msgpack messages, and both sides of a connection negotiate the same
implementation-independent format (RFC 8439 test vectors pinned in
tests/test_tick_cache.py).  Interoperates bit-for-bit with
cryptography.hazmat's ChaCha20Poly1305.
"""

from __future__ import annotations

import hmac
import struct

_MASK32 = 0xFFFFFFFF
_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
_U32X16 = struct.Struct("<16I")


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & _MASK32
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & _MASK32
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & _MASK32
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & _MASK32


def _block(state16: list[int]) -> bytes:
    s = list(state16)
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return _U32X16.pack(
        *((s[i] + state16[i]) & _MASK32 for i in range(16))
    )


def _chacha20_stream(key: bytes, nonce: bytes, counter: int,
                     length: int) -> bytes:
    base = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *struct.unpack("<8I", key),
        counter,
        *struct.unpack("<3I", nonce),
    ]
    out = bytearray()
    while len(out) < length:
        out += _block(base)
        base[12] = (base[12] + 1) & _MASK32
    return bytes(out[:length])


def _xor(data: bytes, stream: bytes) -> bytes:
    return (
        int.from_bytes(data, "little") ^ int.from_bytes(stream, "little")
    ).to_bytes(len(data), "little")


def _poly1305(msg: bytes, key: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        n = int.from_bytes(msg[i:i + 16] + b"\x01", "little")
        acc = ((acc + n) * r) % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"" if rem == 0 else b"\x00" * (16 - rem)


class ChaCha20Poly1305:
    """Drop-in for cryptography.hazmat...aead.ChaCha20Poly1305."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _tag(self, nonce: bytes, ciphertext,
             aad: bytes) -> bytes:
        otk = _chacha20_stream(self._key, nonce, 0, 32)
        mac_data = (
            aad + _pad16(aad)
            # bytes() is a no-op for bytes input and unwraps the
            # zero-copy memoryview the framing layer hands decrypt()
            + bytes(ciphertext) + _pad16(ciphertext)
            + struct.pack("<QQ", len(aad), len(ciphertext))
        )
        return _poly1305(mac_data, otk)

    def encrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = associated_data or b""
        ct = _xor(data, _chacha20_stream(self._key, nonce, 1, len(data)))
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise ValueError("ciphertext too short")
        aad = associated_data or b""
        ct, tag = data[:-16], data[-16:]
        if not hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise ValueError("MAC check failed")
        return _xor(ct, _chacha20_stream(self._key, nonce, 1, len(ct)))
